"""Drives the PyTorch / CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase; one CUDA card
    python3 chip_smoke.py --phases k4,k5,ring   # a subset

Builds every kernel of the serving, training and sequence-parallel paths
from ``ray_tpu_torch/csrc`` with nvcc (sm_90a), all sources at once, then
runs twenty-four phases and fails (exit 1) if any check fails:

* k1      — the flash-attention forward kernel against its plain PyTorch
            version at the serving and training shapes, bf16, causal and
            not, GQA and MHA: max abs error of o and lse, kernel / plain /
            SDPA ms (CUDA events after warm-up; SDPA is the yardstick only,
            the port never calls it) and the least time the card could take.
* k23     — the backward kernels (K2 dq, K3 dk/dv) against their plain
            version on the same o and lse, at the training flagship's shape,
            Llama-3-8B's heads, a ragged s and an MHA hd-64 shape, causal
            and not: relative error of each gradient and of the delta K2
            writes, two K2 launches bitwise equal, kernel / plain ms, the
            bound, and SDPA's backward as the yardstick.
* forward — ``forward`` at llama3_8b (full width, full depth, random bf16
            weights from a seed) on 1 x 2048 tokens with
            attention_impl="flash" against "xla": 32 kernel launches, top-1
            agreement, max abs difference of the log-softmax.
* serve   — a ``PagedEngine`` at llama3_8b answers 4 concurrent greedy
            requests (one admitted mid-decode); every first token must equal
            the argmax of the "xla" forward at the last prompt position; then
            ``LLMServer`` answers one batched and one streamed completion.
* train   — ``make_train_step`` on the repo's training flagship (317M, full
            width and depth, fp32 params, bf16 compute, remat "dots") takes
            10 timed AdamW steps on one seeded 8 x 2048 batch: finite,
            falling loss, K1/K2/K3 launches per step, tokens/s, MFU, peak
            memory, one profiled step, the kernels of one flash backward
            (K2 and K3 alone); then flash against xla on one step's loss
            and gradients.
* k4      — the ring-hop kernel (K4) against its plain version
            (``_chunk_xla``) at the training ring's hop (b1 h8 kvh4 s2048
            hd128) and Llama-3-8B's heads (s512), unmasked and diagonal
            hops, from a fresh and a carried state: o/l, m and l, kernel /
            plain / SDPA-forward ms and the bound.
* k5      — the ring-hop backward (K5: K2 with an fp32 dq, K3 with fp32
            dk/dv) against ``_hop_bwd_xla`` at the same shapes, causal and
            not, with the global lse/delta of a two-hop forward.
* route   — the three public entries on CUDA inputs the kernels do not
            take (fp32; bf16 at head_dim 32), forward and backward: no
            kernel launch, and the plain versions' results on the card;
            an empty bf16 batch launches nothing either.
* ring    — the sequence-parallel path on sp 4: four processes on the one
            card over a gloo group (NCCL refuses two ranks on one GPU), every
            collective staged through host memory. Ring and Ulysses attention
            forward and backward at b1 h8 kvh4 hd128 over s 32768 against the
            whole-sequence flash attention, K4 / K2 / K3 launches counted;
            then ``make_train_step`` on the flagship at 4 of its 16 layers
            (RING_TRAIN_LAYERS, full width: a depth cut for the time
            budget) with "ring" at b1 s8192 (2048 a rank), one warm-up and
            3 steps, losses against a single-process "flash" run. Its times are not the ring's speed:
            the ranks time-slice the card.
* shard   — sharded training on fsdp 2 x tp 2: four processes on the card
            over gloo as in ``ring``. ``make_train_step`` on the flagship
            at 8 of its 16 layers (SHARD_LAYERS, full width: a depth cut
            for the time budget; ``pipe`` and their single-device
            reference share it) ("flash", remat "dots") at b8 x 2048 from
            one seed, each rank
            holding a quarter of the parameters and AdamW moments: one
            warm-up and 2 timed steps, each loss against the single-device
            "flash" step, the gathered gradients of the first step and the
            parameters after it against its, K1 16 / K2 8 / K3 8
            launches a step a rank at the rank's shape (b4 h4 kvh2 s2048
            hd128), the step's seconds and each rank's peak memory. Its
            times measure time-slicing too.
* pipe    — GPipe over pp 4 (``parallel/pipeline.py``): four processes
            on the card over gloo, as in ``shard``, each a stage of 2 of
            the shard phase's 8 layers ("flash", no remat) at full width;
            8 microbatches of one sequence of the b8 x 2048 train batch,
            one warm-up and 2 timed steps. Gates: each loss within 1e-2 of
            the single-device "flash" step; each rank's step-one
            gradients and parameters against the reference's layers
            [2s, 2s + 2), tok_emb, norm and lm_head (the shard phase's
            tolerances); K1 = K2 = K3 = 16 launches a step a rank, all at
            (1, 8, 4, 2048, 128) causal, K4 none; 201 MB of hand-offs a
            step. Step ms and peak memory a rank, the bubble share 3/11;
            its times measure time-slicing too. ``k1``/``k23`` hold K1-K3
            at that shape.
* vit     — ViT-B/16 (86.5M parameters, 224² images, patch 16, 12 layers,
            12 heads of 64) at full width and depth: fp32 parameters, bf16
            compute, "flash", no remat, one seeded batch of 128 NHWC
            images; one warm-up and 10 timed AdamW steps. Gates: finite,
            falling loss; K1, K2 and K3 12 a step each, every launch at
            (128, 12, 12, 196, 64) and unmasked; flash against xla on the
            loss after 3 steps (1e-2), the step-one head gradients (cosine
            >= 0.99) and the forward of converted weights with a nonzero
            head (top-1 agreement). Step ms, images/s, peak memory, one
            profiled step. ``k1``/``k23`` hold K1-K3 at that shape.
* moe     — ``moe_ffn`` at Mixtral-8x7B's FFN widths (d_model 4096, d_ff
            14336, 8 experts, top-2; the JAX package's GELU pair) on 4096
            bf16 tokens at capacity factor 2 against a per-token reference
            on the card (1e-2), its dropped slots and its combine weights;
            then ``moe_ffn_ep`` over tp 4 (four processes on the card over
            gloo, as in ``shard``) on 1024 tokens at capacity factor 8,
            its outputs and router / w_in / w_out gradients against the
            single shard's. ms a call, tokens/s, the exchange's bytes; the
            plain products run no kernel of the port.
* ckpt    — checkpoints (``ray_tpu_torch.train``) of the shard phase's
            state at 4 of the flagship's 16 layers (CKPT_LAYERS, full
            width: a depth cut for the time budget), four processes on the
            card over gloo: each rank takes
            step 1, saves its train state in the JAX package's layout
            through ``AsyncCheckpointWriter`` into a ``CheckpointManager``
            staging dir (rank 0 finalizes with 4 ranks) and takes step 2
            while the write runs. Same-world restore: each rank restores
            into a fresh state (``load_state``), every block, moment and
            the count bitwise as saved, and its step 2 within 1e-6 of the
            uninterrupted one. Cross-world restore: a process of its own
            restores the 4 rank files into one device
            (``load_consolidated``) and takes step 2, within the shard
            phase's tolerances of the sharded loss and parameters. K1/K2/K3
            8/4/4 on each restored step. Bytes a rank and in all, the
            seconds ``save`` blocks, the write's and both restores' seconds
            and GB/s, the consolidating process's peak host memory.
* rl      — the rllib learners (PPO, IMPALA's V-trace, APPO, DQN, SAC, BC
            discrete and continuous, CQL) at their default widths on a
            seeded batch (4096 rows for PPO, minibatch 128, 4 epochs; 256
            for the others): 20 updates on the card against the same
            learner on the CPU from the same weights, batches and (SAC)
            noise, every metric and final parameter within 1e-4; ms an
            update. Their products are PyTorch's own: the JAX package has
            no kernel for them.
* runtime — the port's own task and actor runtime on the card:
            ``ray_tpu_torch.init`` with ``RT_GPU_AUTODETECT=1`` (the GPU
            resource detected, a node label with the card's name); a
            num_gpus=1 task makes one K1 call at the serve shape (1
            launch, the k1 phase's gate); a num_gpus=1 actor builds
            ``LLMServer`` at llama3_8b (full width and depth, random bf16
            weights from the seed) and a ``PagedEngine`` on its weights,
            and answers the serve phase's 4 requests streamed back through
            the object plane (first tokens the plain forward's argmax, 128
            K1 launches, the engine's gauges read through the metrics
            plane; TTFT and tokens/s beside the serve phase's); neither the
            node daemon nor the control store maps CUDA or torch; a second
            num_gpus=1 actor waits until the first is killed; two
            num_gpus=0.5 actors live at once, each runs the same fp32
            product on the card (the same result; the GPU reads 0.0
            available) and a third waits until one of them is killed,
            then runs; a 256 MiB
            bf16 CUDA tensor put by the driver is read by a num_gpus=1 task
            bitwise (GB/s host-staged, with the stages of put and get
            timed apart); the dashboard (``start_dashboard(port=0)`` on
            this cluster): while the engine serves, ``/metrics`` scraped
            shows the actor engine's ``rt_llm_kv_blocks_in_use`` and
            ``rt_llm_batch_occupancy`` above 0; every ``/api`` route the
            page fetches answers JSON; ``/api/jax_profile`` on the node
            returns chrome traces (``traceEvents``), each route's seconds
            printed; after shutdown no process of this cluster (its
            session) is left.
* trainer — ``TorchTrainer`` (``ray_tpu_torch.train``) on the port's
            cluster (``init(num_cpus=4)``, the GPU detected): one
            ``use_gpu`` worker (a ``{"GPU": 1}`` lease) trains the
            flagship at 4 of its 16 layers (TRAINER_LAYERS, full width: a
            depth cut for the time budget; the train phase's seed, batch,
            lr and remat, "flash") for 9 steps, reporting each and
            checkpointing the
            train state after steps 2, 5 and 8 (``num_to_keep=2``); its
            first attempt exits after step 4's report, the controller
            restarts it on a fresh worker from the step-2 checkpoint and
            it runs steps 3 to 9. Gates: every loss within 1e-2 of the
            same config's in-process step; the resumed steps 3 and 4
            within 1e-5 of the killed run's; K1/K2/K3 8/4/4 a step in
            the worker, on the card; checkpoints 5 and 8 kept, the 8 read
            by ``Checkpoint.load_state`` in this process stepping to the
            worker's step-9 loss (1e-5); no process left after shutdown.
            Cluster and worker start s, step ms in the worker against the
            train phase's, the s each report blocks, kill to the resumed
            worker's first step; in-process step ms at the same depth.
* stages  — the flagship trained by 2 pipeline-stage actors of 8 layers
            (``train/pipeline_actors.py``, "flash", no remat), 4
            microbatches of 2 x 2048 of the train batch, 3 steps by
            ``ActorPipeline``, then 3 by ``CompiledActorPipeline`` (the
            compiled DAG over shm channels, slot_size 9 MiB: a microbatch's
            8 MiB bf16 activation and its header); on one card both stages
            share it without leases, each stage gets a num_gpus=1 lease
            where the host has a card a stage. Gates: losses within 1e-2
            of ``make_train_step`` in process (no remat, same seed), eager
            and compiled within 1e-3 of each other; K1 64, K2 32, K3 32 a
            step a stage (forward, then the backward's recompute and its
            gradients); 64 MiB of activations and gradients handed on a
            step. Step s of each. ``k1``/``k23`` hold K1-K3 at the stage
            microbatch (2, 8, 4, 2048, 128).
* apps    — the port's serve library and LLM apps on its cluster
            (``init(num_cpus=8)``, the GPU detected), Llama-3-8B at full
            width and 8 of its 32 layers (APPS_LAYERS: a depth cut for the
            time budget; random bf16 weights from the seed) in every
            process and in the in-process references, the serve phase's
            engine config, greedy decoding, 4
            prompts of the serve phase's lengths (37 / 130 / 300 / 511 byte
            tokens), a urllib client. ``build_openai_app`` behind
            ``serve.start(http_port=0)``: one batched POST of the 4 prompts
            gives the in-process ``LLMServer``'s texts, finish reasons and
            completion-token count, one SSE stream its chunks and the
            batch's text, ending with [DONE]. ``build_pd_app`` (1 prefill
            worker, 1 decode engine): each response's text and completion
            tokens, and the token ids the decode engine streamed, the
            in-process ``PagedEngine``'s; K1 8 a prompt in the prefill
            worker, 0 in the decode engine; a repeated prompt a
            prefill-cache hit (no launch) on the same decode replica; each
            hand-off's KV bytes 2 x 8 x blocks x 16 x 8 x 128 x 2 (16 MiB
            at 511 tokens).
            ``build_dp_app`` (dp 2, the prompts at once): both ranks answer,
            the same texts, counts and ids, 32 K1 launches over the two
            engines.
            Then a deployment of this script's asking for 2 one-GPU
            replicas (``min_replicas=2``): on one card one runs (seeing one
            device), the other waits and the controller publishes its
            {"GPU": 1} demand; on two or more both run. Each app is deleted
            before the next, and the actors its ingress made are killed
            (as in the JAX package, they outlive the replica), so at most
            three model copies share the card, none leased. No process of the cluster is left
            after ``serve.shutdown()`` and ``shutdown()``. Printed: each
            app's start s, TTFT p50 through HTTP SSE and the PD and DP
            ingresses (one-token requests) beside the runtime phase's actor
            and the serve phase's engine, DP tokens/s, the PD hand-off's
            bytes and its share of the TTFT. The counts come from
            ``_apps_install``, which every app process runs as it
            unpickles its ``LLMConfig``.
* data    — the port's data library on its cluster (``init(num_cpus=4)``).
            (a) ``data.range(88, parallelism=11)``, each row id i mapped by
            ``map_batches`` to 2048 tokens from seed SEED + 100 + i, left
            unmaterialized so it streams, through
            ``iter_batches(batch_size=8, device_put=True)`` into the train
            phase's ``make_train_step`` (the flagship, "flash", remat
            "dots"): one warm-up and 10 timed steps. The reference: a fresh
            state from the same seed stepped on the same 11 batches made
            here and moved by ``torch.from_numpy(b).to(dev)``. Gates: every
            loss bitwise the reference's; the batches int32 on the card (as
            JAX's ``device_put`` gives); K1/K2/K3 32/16/16 a step. Printed:
            step ms fed by the iterator and from tensors on the card, host
            ms in ``next()`` a batch and the copy's share of it (the cast
            into pinned memory and the copy, timed alone on the same
            batches), the device's idle share over one
            profiled step (its batch fetched inside it), peak memory.
            (b) ``llm.batch_completions`` at llama3_8b at the apps phase's
            8 of 32 layers (random bf16 weights from the seed; the
            in-process server too) over ``from_items`` of the apps phase's 4
            prompts, ``parallelism=2``, 32 greedy tokens; each map worker
            builds its model on the card. Gates: 4 rows, each completion
            the in-process ``LLMServer``'s for the block the row is in (what
            a map task computes), every token id each map worker generated
            equal to the in-process ones, at most two workers built a model,
            one each; the texts also those of the in-process server given
            all 4 prompts at once. Printed: seconds from the call to the
            last row, and whether that server's token ids agree (batched
            greedy decoding depends on the batch). The counts come from ``_data_install``, which each map
            worker runs as it unpickles the ``LLMConfig``. No process of the
            cluster is left after ``shutdown()``.
* algos   — the rllib algorithms on the port's cluster (``init(num_cpus=4)``,
            no GPU lease: the env runners infer on their CPU and the
            learners run in this process on the card). (a) MultiAgentPPO
            on ``test_rllib_multi_agent.py``'s matching game, independent
            and shared policies (hidden 32 x 32, lr 3e-3), 2 runners of 200
            env steps, 5 iterations with the learners on the card; the
            first iteration against the same config with its learners on
            the CPU from the same weights and seeds: the batches each
            learner is handed equal, every weight leaf within TOL_RL (the
            rl phase's ||err|| / ||ref||); no runner process holds the
            card's device files (/dev/nvidia*: a CUDA context), which this
            process, whose learners use the card, does. (b) BC (expert transitions) and CQL (20 % random
            actions) from a ``ray_tpu_torch.data`` Dataset of 4096
            transitions of the game's scripted expert, 3 epochs each with
            the learner on the card: greedy actions equal the expert's on
            all 256 held-out seeded observations (both packages reach that
            on the CPU after one epoch, seeds 0-2). Printed: ms an
            iteration, learner ms an update, env steps/s, samples/s.
            PPO and DQN on CartPole wait for gymnasium on the card's
            machine (not installed there). A heartbeat watch runs beside
            it (``_BeatWatch``: the node's last beat as the store stamped
            it, both loops' round trips, the daemon's /proc reads, the
            host's scheduling; a beat 3 s late dumps the daemon's and the
            store's stacks), printed, not gated: the phase fails anyway if
            the node's health check times out.

* collective — the device object plane and the collective groups
            (``ray_tpu_torch.util.collective``, ``experimental/rdt.py``,
            ``experimental/device_channel.py``, ``gpu/slice.py``) on one
            cluster (``init(num_cpus=4)``, the GPU detected). rdt: a 256 MiB
            bf16 CUDA tensor put by this process is read back by it as the
            tensor itself (``device_hits`` + 1, no host-to-device copy under
            ``torch.profiler``); after ``add_(1)`` a get rebuilds the
            put-time values from the host bytes (``host_rebuilds`` + 1, the
            profiler seeing the copy); a num_gpus=1 actor reads it
            host-staged with the put-time checksums; the get times printed
            side by side. That actor then makes a one-rank NCCL group (its
            own ``ProcessGroupNCCL``) and runs one all-reduce through it
            (NCCL's version printed; one card cannot hold two NCCL ranks).
            A gloo group of two num_gpus=0.5 actors carrying CUDA tensors:
            allreduce and reducescatter (sum, product, max, min), reduce,
            broadcast, allgather, permute, barrier and send/recv, each
            exactly its numpy twin on integer-valued data, outputs on the
            card (send/recv's on the CPU, in their dtype), inputs
            unchanged; then 3 ``DeviceChannel`` transfers of a (4096, 4096)
            bf16 tensor, equal on arrival, on the card. Gang placement:
            ``slice_placement_group`` of the node's own NVLink domain (its
            ``gpu-pod-type`` and ``gpu-topology`` labels), ``dispatch`` on
            it (node id, CUDA_VISIBLE_DEVICES), then a 1-worker
            ``TorchTrainer`` with ``ScalingConfig(use_gpu=True, topology=,
            accelerator_type=)`` and a numpy train fn. No process of the
            cluster is left after ``shutdown()``.

* ops     — the preemption watcher, the profiler, tune and job submission
            (``gpu/preemption.py``, ``gpu/profiler.py``, ``tune/``,
            ``job_submission/``) on one ``cluster_utils.Cluster`` of two
            daemons on this host, each advertising the card as {"GPU": 1},
            the second labelled spot. The model is the trainer phase's (the
            flagship at 4 of 16 layers, "flash", remat "dots", its seed,
            batch and lr), held to the same steps in this process
            (TOL_TRAINER_LOSS). profile: a num_gpus=1 actor on the spot
            node takes one step while ``capture_on_node(..., port=)``
            records it through the actor's ``init_profiler`` listener; the
            chrome trace's K1/K2/K3 kernel events equal the actor's launch
            counters (8/4/4), their summed device ms printed. jobs (beside
            the profile, while this process computes the references): a
            ``resources={"GPU": 1}`` job whose entrypoint (``chip_smoke.py
            --ops-job``) joins the cluster and takes one step SUCCEEDS, its
            logs holding the card's name and the in-process loss; then a
            looping GPU job is stopped (STOPPED) and the GPU it held
            returns. tune: ``Tuner`` with ``ASHAScheduler`` (max_t 6, grace
            1, factor 2) over 3 learning rates, each trial on half of the
            head's card (``trial_resources={"GPU": 0.5}`` and the head's
            ``ops_head`` resource), two at a time, the worst last: every
            trial's losses the in-process ones, ASHA stops at least one,
            ``get_best_result`` the lowest loss. preempt (beside tune): a
            ``TorchTrainer`` whose one worker holds half a card starts on
            the spot node (the first trials hold the head's card) and
            checkpoints every 2 steps; after step 2's checkpoint a
            ``testing_preempt_wave`` sent through ``chaos_set`` reaches the
            spot daemon's watcher, which publishes the notice and drains
            the node (reason preemption, 6 s deadline); the controller
            counts one planned rejoin and no failure, and steps 3-6 run on
            the head's card from the step-2 checkpoint, beside the last
            trial, every loss the uninterrupted run's. Printed: each
            stage's seconds, notice to PREEMPTING, DRAINING, DEAD and the
            resumed step. No process of the cluster is left after
            shutdown.

* scale   — the autoscaler (``ray_tpu_torch/autoscaler``) on one head with
            no GPU (``init(num_cpus=4)``, no detection). (a) ``up``'s
            local provider: an ``Autoscaler`` over ``SliceNodeProvider``
            (worker type {"CPU": 2, "GPU": 1}, at most 1, idle timeout 3
            s, poll 0.3 s); a num_gpus=1 task makes the runtime phase's K1
            call (1 launch, the k1 phase's gate). Gates: one
            ``create_node``; the task ran on that node; once idle the node
            is drained, then terminated, its daemon exits and its death
            record says expected. (b) ``GpuVmNodeProvider`` on
            ``FakeGcpTransport``, whose boot starts one daemon a host on
            the card with the metadata's resources, the head token on host
            0 and the domain labels, as a VM's startup script would; the
            pod type is the card's (``H100-1``). A ``TorchTrainer`` with
            ``ScalingConfig(num_workers=1, use_gpu=True, topology="1x1",
            accelerator_type=...)``: its domain reservation is the demand.
            The worker takes 2 steps of the trainer phase's cell (the
            flagship at 4 of 16 layers, full width) while this process
            computes them. The boot labels each daemon with its instance
            name (``gcp.INSTANCE_LABEL``), by which the autoscaler matches
            it to its handle. Gates: one insert and one domain; the steps
            on the domain's node, K1/K2/K3 8/4/4 a step; every loss bitwise
            the in-process one; no reconcile failed; once the trainer is
            done the idle domain is drained and terminated (the idle
            timeout of (a)) before ``scaler.stop()``: no instance and no
            daemon of the domain, each host's death record expected.
            Printed: submit to ALIVE, to the task's result, idle to
            terminated; fit to the domain ALIVE, to the first step; idle
            to drained and to terminated. No process of the cluster is
            left after ``shutdown()``.

The line before the last is the ``kernels`` JSON record, the last line
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
TOL_O = 2e-2               # o, absolute, plus TOL_O_REL of |o|: bf16
TOL_O_REL = 1e-2           # rounds the output once (2^-8 relative)
TOL_LSE = 1e-3             # lse is kept in fp32
SEED = 0

# (b, h, kvh, s, hd): the serving path's prompt buckets and the forward's
# 2048, at Llama-3-8B's heads; one MHA shape at head_dim 64; the training
# flagship's shape, and a rank's share of it in the shard phase (half the
# rows over fsdp, half the heads over tp); ViT-B/16's at the vit phase's
# batch (196 patches: every 64-row tile of it a tail tile); the pipe
# phase's microbatch
VIT_SHAPE = (128, 12, 12, 196, 64)
# a pipe-phase microbatch: one sequence of the flagship, all 8 heads
PIPE_SHAPE = (1, 8, 4, 2048, 128)
# a stages-phase microbatch: two sequences of the flagship (8 / 4)
STAGE_SHAPE = (2, 8, 4, 2048, 128)
K1_SHAPES = [(1, 32, 8, s, 128) for s in (64, 200, 256, 512, 2048)] + [
    (2, 8, 8, 384, 64), (8, 8, 4, 2048, 128), (4, 4, 2, 2048, 128),
    VIT_SHAPE, PIPE_SHAPE, STAGE_SHAPE]
K1_MAIN_SHAPE = (1, 32, 8, 512, 128)  # the serve phase's largest bucket


def _fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _check(cond: bool, msg: str):
    if not cond:
        _fail(msg)


HOLD_CYCLES = 100_000_000  # ~50 ms of a spin kernel at the H100's clocks


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold the stream so the host has queued every launch before the device
    # reaches the first: the events then time the device, not the Python
    # wrapper's per-call overhead
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# SASS opcodes that show a library's design: HGMMA is wgmma, UTMALDG a TMA
# load, LDGSTS a cp.async copy, HMMA mma.sync
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA")


def _demangle(names):
    """Kernels' C++ names, template arguments and all, from their symbols
    (``cu++filt`` beside nvcc; the symbols themselves where that fails)."""
    from ray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    try:
        out = subprocess.run([tool, *names], capture_output=True, text=True)
    except OSError:
        return list(names)
    lines = out.stdout.splitlines()
    return lines if len(lines) == len(names) else list(names)


def build_info(paths):
    """For each built library: the SASS opcode counts of ``SASS_OPS``
    (``cuobjdump --dump-sass``) and ptxas's report of each kernel's
    registers and spills. Printed, not gated."""
    import re

    from ray_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    info = {}
    for lib, path in paths.items():
        entry = {}
        sass = subprocess.run([cuobjdump, "--dump-sass", path],
                              capture_output=True, text=True)
        if sass.returncode == 0:
            entry["sass"] = {op: len(re.findall(rf"\b{op}\b", sass.stdout))
                             for op in SASS_OPS}
        else:
            entry["sass"] = f"not measured: {sass.stderr.strip()[:200]}"
        log = _build.log_path(lib)
        if os.path.exists(log):
            with open(log) as f:
                text = f.read()
            # per kernel: "Used N registers" and its spill line
            chunks = text.split("Compiling entry function '")[1:]
            names = _demangle([c.split("'", 1)[0] for c in chunks])
            kernels = {}
            for name, chunk in zip(names, chunks):
                regs = re.search(r"Used (\d+) registers", chunk)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", chunk)
                kernels[name] = dict(
                    registers=int(regs.group(1)) if regs else None,
                    spill_bytes=int(spill.group(1)) + int(spill.group(2))
                    if spill else None)
            entry["kernels"] = kernels
            entry["warnings"] = sorted({line.strip() for line in
                                        text.splitlines()
                                        if "warning" in line.lower()
                                        or "Performance Loss" in line})
        info[lib] = entry
    return info


def _k1_bound(b, h, kvh, s, hd, causal):
    """(bound_ms, bound_by, flops, bytes) for one K1 call: each input read
    once, each output written once; causal counts the s(s+1)/2 pairs the
    mask keeps."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4.0 * b * h * hd * pairs
    nbytes = 2.0 * (2 * b * h * s * hd + 2 * b * kvh * s * hd) + 4.0 * b * h * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def phase_k1(dev):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for (b, h, kvh, s, hd) in K1_SHAPES:
        q = torch.randn((b, h, s, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, kvh, s, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, kvh, s, hd), generator=gen, device=dev).bfloat16()
        for causal in (True, False):
            o, lse = fa._flash_fwd_cuda(q, k, v, causal)
            torch.cuda.synchronize()
            ro, rlse = fa._attention_reference(q, k, v, causal)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            finite = bool(torch.isfinite(o).all()) and bool(
                torch.isfinite(lse).all())
            ms = _time_ms(lambda: fa._flash_fwd_cuda(q, k, v, causal))
            plain_ms = _time_ms(
                lambda: fa._attention_reference(q, k, v, causal), iters=5)
            sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=kvh != h))
            bound_ms, bound_by, flops, nbytes = _k1_bound(
                b, h, kvh, s, hd, causal)
            row = dict(b=b, h=h, kvh=kvh, s=s, hd=hd, causal=causal,
                       err_o=err_o, err_lse=err_lse, ms=ms,
                       plain_ms=plain_ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms,
                       bound_by=bound_by, frac_of_bound=bound_ms / ms,
                       x_library=ms / sdpa_ms,
                       tflops=flops / (ms * 1e-3) / 1e12,
                       gbytes=nbytes / 1e9)
            rows.append(row)
            print(json.dumps({"k1": row}), flush=True)
            _check(finite, f"K1 output not finite at {row}")
            # o: |err| <= TOL_O + TOL_O_REL |ref| (bf16 rounds o once)
            o_ok = bool(((o.float() - ro.float()).abs()
                         <= TOL_O + TOL_O_REL * ro.float().abs()).all())
            _check(o_ok and err_lse <= TOL_LSE,
                   f"K1 disagrees with _attention_reference beyond "
                   f"o {TOL_O} + {TOL_O_REL}|o| / lse {TOL_LSE}: {row}")
    return rows


# (b, h, kvh, s, hd) of the K2/K3 check: the training flagship's heads and
# batch first (the main path's shape), Llama-3-8B's (rep 4), a ragged s,
# one MHA shape at head_dim 64, a shard-phase rank's share of the flagship
# (its grid is a quarter of the flagship's), ViT-B/16's, a pipe-phase
# microbatch's and a stages-phase microbatch's
K23_SHAPES = [(8, 8, 4, 2048, 128), (1, 32, 8, 2048, 128),
              (1, 32, 8, 200, 128), (2, 8, 8, 384, 64), (4, 4, 2, 2048, 128),
              VIT_SHAPE, PIPE_SHAPE, STAGE_SHAPE]
K23_MAIN_SHAPE = K23_SHAPES[0]
# each gradient is accumulated in fp32 and rounded to bf16 once (2^-8
# relative): per tensor, ||err|| / ||ref|| and max|err| / max|ref|
TOL_GRAD_NORM = 1e-2
TOL_GRAD_MAX = 2e-2
# the delta K2 writes against torch's fp32 rowsum of the same bf16 values:
# the same sum in another order, ||err|| / ||ref||
TOL_DELTA = 1e-5


def _k23_bounds(b, h, kvh, s, hd, causal, grad_bytes=2, fused_delta=True):
    """{kernel: (bound_ms, bound_by, flops, bytes)} for K2 and K3: the JAX
    cost estimates' 3 and 4 products of 2 b h hd per (q, k) pair, over the
    s(s+1)/2 pairs the causal mask keeps; each input read once, each output
    written once: q, k, v, dO, lse and delta read, the gradients written
    (``grad_bytes`` an element: 4 for the ring hop's fp32 gradients, K5),
    except that K2 with ``fused_delta`` (the training path's) reads o and
    writes delta instead of reading delta."""
    pairs = s * (s + 1) / 2 if causal else s * s
    qbytes, kvbytes, rows = 2.0 * b * h * s * hd, 2.0 * b * kvh * s * hd, \
        4.0 * b * h * s
    read = 2 * qbytes + 2 * kvbytes + 2 * rows
    w = grad_bytes / 2
    k2_delta = qbytes if fused_delta else 0.0  # o read; delta written, not read
    out = {}
    for name, products, moved in (("k2", 3, read + k2_delta + w * qbytes),
                                  ("k3", 4, read + w * 2 * kvbytes)):
        flops = 2.0 * products * b * h * hd * pairs
        t_ops = flops / PEAK_BF16_FLOPS
        t_bytes = moved / PEAK_HBM_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     moved)
    return out


def _grad_errors(got, want):
    """(max|err|, ||err|| / ||ref||, max|err| / max|ref|) in fp32."""
    got, want = got.float(), want.float()
    err = got - want
    return (err.abs().max().item(), (err.norm() / want.norm()).item(),
            (err.abs().max() / want.abs().max()).item())


def phase_k23(dev):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for (b, h, kvh, s, hd) in K23_SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).bfloat16()

        q, k, v, g = (randn(b, h, s, hd), randn(b, kvh, s, hd),
                      randn(b, kvh, s, hd), randn(b, h, s, hd))
        for causal in (True, False):
            # o and lse from the plain forward, fed to both sides, so the
            # backward kernels are held alone
            o, lse = fa._attention_reference(q, k, v, causal)
            dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, g, causal)
            torch.cuda.synchronize()
            ref = fa._flash_bwd_reference(q, k, v, o, lse, g, causal)
            row = dict(b=b, h=h, kvh=kvh, s=s, hd=hd, causal=causal)
            ok = True
            for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                finite = bool(torch.isfinite(got).all())
                mx, rel_norm, rel_max = _grad_errors(got, want)
                row[f"err_{name}"] = mx
                row[f"rel_norm_{name}"] = rel_norm
                row[f"rel_max_{name}"] = rel_max
                ok = ok and finite and rel_norm <= TOL_GRAD_NORM \
                    and rel_max <= TOL_GRAD_MAX
            # the delta K2 writes (the K3 above read it), and two K2 launches
            # on the same inputs: bitwise equal (no atomics)
            delta = (g.float() * o.float()).sum(-1)
            fused = [torch.full_like(delta, float("nan")) for _ in range(2)]
            dq2 = [fa._launch_dq(q, k, v, g, lse, d, causal, o=o)
                   for d in fused]
            torch.cuda.synchronize()
            row["rel_norm_delta"] = ((fused[0] - delta).norm()
                                     / delta.norm()).item()
            row["k2_bitwise_equal"] = torch.equal(dq2[0], dq2[1]) \
                and torch.equal(fused[0], fused[1]) and torch.equal(dq2[0], dq)
            ok = ok and row["rel_norm_delta"] <= TOL_DELTA \
                and row["k2_bitwise_equal"]
            if (b, h, kvh, s, hd) == K23_MAIN_SHAPE and causal:
                # the fp32-dq variant (the ring-hop backward's: delta read)
                # at one shape
                dq32 = fa._launch_dq(q, k, v, g, lse, delta, causal,
                                     dq_fp32=True)
                ref32 = fa._flash_bwd_reference(q.float(), k, v, o, lse, g,
                                                causal)[0]
                _, rel_norm, rel_max = _grad_errors(dq32, ref32)
                row["rel_norm_dq_fp32"] = rel_norm
                ok = ok and dq32.dtype == torch.float32 and bool(
                    torch.isfinite(dq32).all()) and rel_norm <= TOL_GRAD_NORM \
                    and rel_max <= TOL_GRAD_MAX
            # K2 as the training path launches it: delta computed and written
            row["k2_ms"] = _time_ms(
                lambda: fa._launch_dq(q, k, v, g, lse, fused[0], causal, o=o))
            row["k3_ms"] = _time_ms(
                lambda: fa._launch_dkv(q, k, v, g, lse, delta, causal))
            row["plain_ms"] = _time_ms(lambda: fa._flash_bwd_reference(
                q, k, v, o, lse, g, causal), iters=3, warmup=1)
            # the library yardstick: SDPA's backward (K2 + K3 together) on a
            # retained graph; the port never calls it
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=kvh != h)
            row["sdpa_bwd_ms"] = _time_ms(lambda: torch.autograd.grad(
                out, (qs, ks, vs), g, retain_graph=True))
            del out, qs, ks, vs
            for name, (bms, by, flops, nbytes) in _k23_bounds(
                    b, h, kvh, s, hd, causal).items():
                row[f"{name}_bound_ms"] = bms
                row[f"{name}_bound_by"] = by
                row[f"{name}_tflops"] = flops / (row[f"{name}_ms"] * 1e-3) \
                    / 1e12
                row[f"{name}_frac_of_bound"] = bms / row[f"{name}_ms"]
            # SDPA's backward does K2's and K3's work in one call
            row["x_library"] = (row["k2_ms"] + row["k3_ms"]) \
                / row["sdpa_bwd_ms"]
            rows.append(row)
            print(json.dumps({"k23": row}), flush=True)
            _check(ok, f"K2/K3 outside ||err||/||ref|| <= {TOL_GRAD_NORM}, "
                   f"max|err| <= {TOL_GRAD_MAX} max|ref|, delta beyond "
                   f"{TOL_DELTA}, two K2 launches unequal or not finite: "
                   f"{row}")
    return rows


# (b, h, kvh, s, hd) of the ring-hop checks (K4, K5), sq = sk = s: the
# training ring's hop first (the flagship's heads, 8192 tokens over sp 4),
# then Llama-3-8B's heads
HOP_SHAPES = [(1, 8, 4, 2048, 128), (1, 32, 8, 512, 128)]
HOP_MAIN_SHAPE = HOP_SHAPES[0]
TOL_M = 1e-3               # K4's running max, absolute (fp32 throughout)
TOL_L_REL = 1e-2           # K4's denominator, relative


def _k4_bound(b, h, kvh, s, hd, causal):
    """(bound_ms, bound_by, flops, bytes) for one K4 call: QK^T and PV over
    the s(s+1)/2 pairs the causal mask keeps; q, k, v (bf16) and o, m, l
    (fp32) read once, the new o, m, l written once."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4.0 * b * h * hd * pairs
    nbytes = 2.0 * (b * h * s * hd + 2 * b * kvh * s * hd) \
        + 2 * 4.0 * (b * h * s * hd + 2 * b * h * s)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def _hop_inputs(dev, gen, b, h, kvh, s, hd):
    """Seeded bf16 q, k, v, dO of one hop, a second K/V block, and the fresh
    ring state (o = l = 0, m = -inf)."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q, k, v, g = (randn(b, h, s, hd), randn(b, kvh, s, hd),
                  randn(b, kvh, s, hd), randn(b, h, s, hd))
    k0, v0 = randn(b, kvh, s, hd), randn(b, kvh, s, hd)
    fresh = (torch.zeros((b, h, s, hd), device=dev),
             torch.full((b, h, s, 1), float("-inf"), device=dev),
             torch.zeros((b, h, s, 1), device=dev))
    return q, k, v, g, k0, v0, fresh


def phase_k4(dev):
    """K4 against ``_chunk_xla`` on the same bf16 inputs, FULL (causal
    False) and DIAG (causal True) hops, from a fresh state and from one a
    previous plain hop carried."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for (b, h, kvh, s, hd) in HOP_SHAPES:
        q, k, v, _, k0, v0, fresh = _hop_inputs(dev, gen, b, h, kvh, s, hd)
        carried = fa._chunk_xla(q, k0, v0, *fresh, False)
        for state_name, state in (("fresh", fresh), ("carried", carried)):
            for causal in (False, True):
                before = [t.clone() for t in state]
                o, m, l = fa._flash_chunk_cuda(q, k, v, *state, causal)
                torch.cuda.synchronize()
                ro, rm, rl = fa._chunk_xla(q, k, v, *state, causal)
                untouched = all(torch.equal(x, y)
                                for x, y in zip(before, state))
                finite = all(bool(torch.isfinite(t).all()) for t in (o, m, l))
                # o is un-normalised (it grows with l): K1's rule holds the
                # attention output o / l
                # and, as K2/K3's gates do, ||err|| / ||ref|| on it: the
                # elementwise rule's 2e-2 is near a typical |o/l| here
                out, rout = o / l, ro / rl
                rel_norm_o = ((out - rout).norm() / rout.norm()).item()
                o_ok = bool(((out - rout).abs()
                             <= TOL_O + TOL_O_REL * rout.abs()).all()) \
                    and rel_norm_o <= TOL_GRAD_NORM
                err_m = (m - rm).abs().max().item()
                rel_l = ((l - rl).abs() / rl.abs()).max().item()
                row = dict(b=b, h=h, kvh=kvh, s=s, hd=hd, causal=causal,
                           state=state_name,
                           err_o=(out - rout).abs().max().item(),
                           rel_norm_o=rel_norm_o,
                           err_o_unnormalised=(o - ro).abs().max().item(),
                           err_m=err_m, rel_err_l=rel_l)
                row["ms"] = _time_ms(
                    lambda: fa._flash_chunk_cuda(q, k, v, *state, causal))
                row["plain_ms"] = _time_ms(
                    lambda: fa._chunk_xla(q, k, v, *state, causal), iters=5)
                # the yardstick: SDPA's forward on the same q, k, v (it
                # carries no state, so it does a little less work)
                row["sdpa_ms"] = _time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=kvh != h))
                bms, by, flops, nbytes = _k4_bound(b, h, kvh, s, hd, causal)
                row.update(bound_ms=bms, bound_by=by,
                           frac_of_bound=bms / row["ms"],
                           x_library=row["ms"] / row["sdpa_ms"],
                           tflops=flops / (row["ms"] * 1e-3) / 1e12)
                rows.append(row)
                print(json.dumps({"k4": row}), flush=True)
                _check(untouched, f"K4 wrote over its input state: {row}")
                _check(finite and o_ok and err_m <= TOL_M
                       and rel_l <= TOL_L_REL,
                       f"K4 disagrees with _chunk_xla beyond o/l {TOL_O} + "
                       f"{TOL_O_REL}|o/l| and ||err||/||ref|| "
                       f"{TOL_GRAD_NORM}, m {TOL_M}, l {TOL_L_REL} relative, "
                       f"or not finite: {row}")
    # the diagonal hop does half the products: its time over the unmasked
    # hop's, per shape and state (printed, not gated)
    ratios = {}
    for r in rows:
        if r["causal"]:
            full = next(f for f in rows if not f["causal"] and all(
                f[k] == r[k] for k in ("b", "h", "kvh", "s", "hd", "state")))
            ratios[f"b{r['b']} h{r['h']} kvh{r['kvh']} s{r['s']} "
                   f"hd{r['hd']} {r['state']}"] = r["ms"] / full["ms"]
    print(json.dumps({"k4_diag_over_full": ratios}), flush=True)
    return rows


def phase_k5(dev):
    """K5 (``flash_hop_bwd``: K2 with an fp32 dq, K3 with fp32 dk/dv)
    against ``_hop_bwd_xla`` on one hop, causal and not, with the global
    lse and delta of a two-hop plain ring forward."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for (b, h, kvh, s, hd) in HOP_SHAPES:
        q, k, v, g, k0, v0, fresh = _hop_inputs(dev, gen, b, h, kvh, s, hd)
        first = fa._chunk_xla(q, k0, v0, *fresh, False)
        for causal in (True, False):
            o, m, l = fa._chunk_xla(q, k, v, *first, causal)
            lse = m + torch.log(l)
            out = (o / l).bfloat16()
            delta = (g.float() * out.float()).sum(-1, keepdim=True)
            got = fa.flash_hop_bwd(q, k, v, g, lse, delta, causal)
            torch.cuda.synchronize()
            ref = fa._hop_bwd_xla(q, k, v, g, lse, delta, causal)
            row = dict(b=b, h=h, kvh=kvh, s=s, hd=hd, causal=causal)
            ok = True
            for name, x, want in zip(("dq", "dk", "dv"), got, ref):
                mx, rel_norm, rel_max = _grad_errors(x, want)
                row[f"err_{name}"] = mx
                row[f"rel_norm_{name}"] = rel_norm
                row[f"rel_max_{name}"] = rel_max
                ok = ok and x.dtype == torch.float32 \
                    and bool(torch.isfinite(x).all()) \
                    and rel_norm <= TOL_GRAD_NORM and rel_max <= TOL_GRAD_MAX
            row["k5a_ms"] = _time_ms(lambda: fa._launch_dq(
                q, k, v, g, lse, delta, causal, dq_fp32=True))
            row["k5b_ms"] = _time_ms(lambda: fa._launch_dkv(
                q, k, v, g, lse, delta, causal, dkv_fp32=True))
            row["plain_ms"] = _time_ms(lambda: fa._hop_bwd_xla(
                q, k, v, g, lse, delta, causal), iters=3, warmup=1)
            # the yardstick: SDPA's backward on the hop block (its own
            # softmax, not the ring's global rows)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            sd = F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=kvh != h)
            row["sdpa_bwd_ms"] = _time_ms(lambda: torch.autograd.grad(
                sd, (qs, ks, vs), g, retain_graph=True))
            del sd, qs, ks, vs
            for name, (bms, by, flops, _) in _k23_bounds(
                    b, h, kvh, s, hd, causal, grad_bytes=4,
                    fused_delta=False).items():
                key = {"k2": "k5a", "k3": "k5b"}[name]
                row[f"{key}_bound_ms"] = bms
                row[f"{key}_bound_by"] = by
                row[f"{key}_tflops"] = flops / (row[f"{key}_ms"] * 1e-3) / 1e12
                row[f"{key}_frac_of_bound"] = bms / row[f"{key}_ms"]
            row["x_library"] = (row["k5a_ms"] + row["k5b_ms"]) \
                / row["sdpa_bwd_ms"]
            rows.append(row)
            print(json.dumps({"k5": row}), flush=True)
            _check(ok, f"K5 outside ||err||/||ref|| <= {TOL_GRAD_NORM}, "
                   f"max|err| <= {TOL_GRAD_MAX} max|ref|, not fp32 or not "
                   f"finite: {row}")
    # the diagonal hop does half of K5b's products: its time over the
    # unmasked hop's, per shape (printed, not gated)
    ratios = {}
    for r in rows:
        if r["causal"]:
            full = next(f for f in rows if not f["causal"] and all(
                f[k] == r[k] for k in ("b", "h", "kvh", "s", "hd")))
            ratios[f"b{r['b']} h{r['h']} kvh{r['kvh']} s{r['s']} "
                   f"hd{r['hd']}"] = r["k5b_ms"] / full["k5b_ms"]
    print(json.dumps({"k5b_diag_over_full": ratios}), flush=True)
    return rows


# inputs the kernels do not take, (dtype, head_dim) at b1 h8 kvh4 s256:
# fp32 at head_dim 64 and bf16 at head_dim 32 (``LlamaConfig.tiny``'s)
ROUTE_CASES = (("fp32", 64), ("bf16", 32))
ROUTE_SHAPE = (1, 8, 4, 256)
# and bf16 views at head_dim 128, which the kernels take through copies
ROUTE_VIEW_HD = 128
# ||err|| / ||ref||: the same plain ops, or the same deterministic kernels,
# on the same values
TOL_ROUTE = 1e-5


def phase_route(dev):
    """The three public entries (``flash_attention_bhsd``,
    ``flash_chunk_bhsd``, ``flash_hop_bwd``) on CUDA inputs the kernels do
    not take, forward and backward: no kernel launches, and the results of
    the plain versions they route to, on the card. Then the same entries on
    bf16 views the kernels do take (head_dim ``ROUTE_VIEW_HD``): they launch,
    through ``_kernel_input``'s copies, and give what they give on
    contiguous copies of the same values."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    b, h, kvh, s = ROUTE_SHAPE

    def grads(fn, inputs, cots):
        xs = [t.detach().requires_grad_() for t in inputs]
        out = fn(*xs)
        outs = list(out) if isinstance(out, tuple) else [out]
        return outs + list(torch.autograd.grad(outs, xs, cots))

    def rel_err(got, want):
        return max(((x.float() - w.float()).norm()
                    / w.float().norm().clamp_min(1e-30)).item()
                   for x, w in zip(got, want))

    for dt_name, hd in ROUTE_CASES + (("bf16", ROUTE_VIEW_HD),):
        dt = getattr(torch, {"fp32": "float32", "bf16": "bfloat16"}[dt_name])
        views = hd == ROUTE_VIEW_HD

        def randn(*shape, dtype=dt):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q, g = randn(b, h, s, hd), randn(b, h, s, hd)
        k, v = randn(b, kvh, s, hd), randn(b, kvh, s, hd)
        f32 = torch.float32
        state = (randn(b, h, s, hd, dtype=f32), randn(b, h, s, 1, dtype=f32),
                 randn(b, h, s, 1, dtype=f32).abs() + 1)
        cot = (randn(b, h, s, hd, dtype=f32), randn(b, h, s, 1, dtype=f32),
               randn(b, h, s, 1, dtype=f32))
        lse, delta = randn(b, h, s, 1, dtype=f32), randn(b, h, s, 1, dtype=f32)
        if views:
            _route_views(fa, grads, rel_err, rows, (q, k, v, g), state,
                         cot, lse, delta)
            continue

        def attn_ref(q, k, v):
            return fa._attention_reference(q, k, v, True)[0]

        cases = {
            "flash_attention_bhsd": (
                lambda: grads(lambda *a: fa.flash_attention_bhsd(*a, True),
                              (q, k, v), (g,)),
                # the plain forward and, as the entry's backward does, the
                # plain backward on its o and lse
                lambda: [attn_ref(q, k, v)] + list(fa._flash_bwd_reference(
                    q, k, v, *fa._attention_reference(q, k, v, True), g,
                    True))),
            "flash_chunk_bhsd": (
                lambda: grads(lambda *a: fa.flash_chunk_bhsd(*a, True),
                              (q, k, v) + state, cot),
                lambda: grads(lambda *a: fa._chunk_xla(*a, True),
                              (q, k, v) + state, cot)),
            "flash_hop_bwd": (
                lambda: list(fa.flash_hop_bwd(q, k, v, g, lse, delta, True)),
                lambda: list(fa._hop_bwd_xla(q, k, v, g, lse, delta, True))),
        }
        for entry, (run, plain) in cases.items():
            _zero_launches(fa)
            got = run()
            torch.cuda.synchronize()
            launches = _read_launches(fa)
            want = plain()
            rel = rel_err(got, want)
            row = dict(entry=entry, dtype=dt_name, hd=hd,
                       kernel_takes=fa._kernel_takes(q, k, v),
                       launches=launches, n_results=len(got),
                       rel_norm_err=rel)
            rows.append(row)
            print(json.dumps({"route": row}), flush=True)
            _check(not row["kernel_takes"]
                   and not any(launches.values())
                   and len(got) == len(want)
                   and all(bool(torch.isfinite(x).all()) for x in got)
                   and rel <= TOL_ROUTE,
                   f"{entry} on {dt_name} hd {hd}: launched a kernel or "
                   f"differs from its plain version beyond ||err||/||ref|| "
                   f"{TOL_ROUTE}: {row}")
    # an empty batch the kernels would take (a pipeline microbatch of which
    # a data rank holds no row): no launch, empty results of its shapes
    q, k, v, g = (torch.zeros((0, n, s, ROUTE_VIEW_HD), device=dev,
                              dtype=torch.bfloat16) for n in (h, kvh, kvh, h))
    _zero_launches(fa)
    got = grads(lambda *a: fa.flash_attention_bhsd(*a, True), (q, k, v),
                (g,))
    torch.cuda.synchronize()
    row = dict(entry="flash_attention_bhsd", dtype="bf16", hd=ROUTE_VIEW_HD,
               batch=0, launches=_read_launches(fa),
               shapes=[tuple(x.shape) for x in got])
    rows.append(row)
    print(json.dumps({"route": row}), flush=True)
    _check(not any(row["launches"].values()) and row["shapes"] == [
        tuple(t.shape) for t in (q, q, k, v)],
        f"an empty batch launched a kernel or lost its shape: {row}")
    return rows


def _view(t, how):
    """A view of ``t``'s values: "transposed" (the transpose of a (b, s,
    h, hd) tensor: not contiguous) or "offset" (contiguous, one element
    into its storage: not 16-byte aligned)."""
    import torch

    if how == "transposed":
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:t.numel() + 1].view(t.shape)
    view.copy_(t)
    return view


def _route_views(fa, grads, rel_err, rows, qkvg, state, cot, lse, delta):
    """The route phase's bf16 views (q and dO transposed, k and v at an odd
    offset) through the three entries: each entry's kernels launch, and its
    results equal the same entry's on the contiguous tensors."""
    import torch

    q, k, v, g = qkvg
    qv, kv, vv, gv = (_view(t, "offset" if i in (1, 2) else "transposed")
                      for i, t in enumerate(qkvg))
    cases = {
        "flash_attention_bhsd": (
            lambda q, k, v, g: grads(
                lambda *a: fa.flash_attention_bhsd(*a, True), (q, k, v), (g,)),
            ("k1", "k2", "k3")),
        "flash_chunk_bhsd": (
            lambda q, k, v, g: grads(
                lambda *a: fa.flash_chunk_bhsd(*a, True), (q, k, v) + state,
                cot),
            ("k4",)),
        "flash_hop_bwd": (
            lambda q, k, v, g: list(fa.flash_hop_bwd(q, k, v, g, lse, delta,
                                                     True)),
            ("k2", "k3")),
    }
    for entry, (run, kernels) in cases.items():
        _zero_launches(fa)
        got = run(qv, kv, vv, gv)
        torch.cuda.synchronize()
        launches = _read_launches(fa)
        want = run(q, k, v, g)
        rel = rel_err(got, want)
        row = dict(entry=entry, dtype="bf16", hd=ROUTE_VIEW_HD,
                   inputs="views", kernel_takes=fa._kernel_takes(qv, kv, vv),
                   launches=launches, n_results=len(got), rel_norm_err=rel)
        rows.append(row)
        print(json.dumps({"route": row}), flush=True)
        _check(row["kernel_takes"]
               and all(launches[n] > 0 for n in kernels)
               and len(got) == len(want)
               and all(bool(torch.isfinite(x).all()) for x in got)
               and rel <= TOL_ROUTE,
               f"{entry} on bf16 views: its kernels {kernels} did not launch "
               f"or differ from their run on contiguous tensors beyond "
               f"||err||/||ref|| {TOL_ROUTE}: {row}")


FWD_TOKENS = 2048
SERVE_PROMPTS = (37, 130, 300, 511)
SERVE_MAX_TOKENS = 32
# flash vs xla forward top-1 agreement: two correct bf16 paths agree on
# ~95% of positions through 32 random layers (this script, H100); a broken
# kernel agrees on almost none
TOP1_MIN = 0.9


def phase_model(dev, phases):
    """The forward and serve phases on one set of llama3_8b weights, then
    LLMServer on its own."""
    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, forward, init_params
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16,
                                attention_impl="flash")
    xcfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    out = {}
    t0 = time.monotonic()
    params = init_params(cfg, SEED)  # the default device: CUDA
    torch.cuda.synchronize()
    out["init_s"] = time.monotonic() - t0
    print(f"init: llama3_8b {cfg.num_params() / 1e9:.3f}B params bf16 in "
          f"{out['init_s']:.2f} s", flush=True)

    if "forward" in phases:
        toks = torch.from_numpy(np.random.RandomState(SEED).randint(
            0, cfg.vocab_size, size=(1, FWD_TOKENS))).to(dev)
        with torch.no_grad():
            forward(cfg, params, toks[:, :64])  # warm-up: cuBLAS, kernel
            torch.cuda.synchronize()
            fa.flash_fwd_launches = 0
            t = time.monotonic()
            lf = forward(cfg, params, toks)
            torch.cuda.synchronize()
            flash_s = time.monotonic() - t
            launches = fa.flash_fwd_launches
            forward(xcfg, params, toks[:, :64])
            torch.cuda.synchronize()
            t = time.monotonic()
            lx = forward(xcfg, params, toks)
            torch.cuda.synchronize()
            xla_s = time.monotonic() - t
            top1 = (lf.argmax(-1) == lx.argmax(-1)).float().mean().item()
            dls = (torch.log_softmax(lf, -1) - torch.log_softmax(lx, -1)
                   ).abs().max().item()
            finite = bool(torch.isfinite(lf).all())
        del lf, lx
        fwd = dict(tokens=FWD_TOKENS, k1_launches=launches,
                   flash_ms=flash_s * 1e3, xla_ms=xla_s * 1e3,
                   top1_agreement=top1, max_abs_logsoftmax_diff=dls)
        out["forward"] = fwd
        print(json.dumps({"forward": fwd}), flush=True)
        _check(finite, "flash forward logits not finite")
        _check(launches == cfg.n_layers,
               f"forward launched K1 {launches} times, want {cfg.n_layers}")
        _check(top1 >= TOP1_MIN,
               f"flash vs xla forward top-1 agreement {top1} < {TOP1_MIN}")

    if "serve" in phases:
        out["serve"] = _serve(dev, cfg, xcfg, params)
    del params
    torch.cuda.empty_cache()
    if "serve" in phases:
        out["llm_server"] = _llm_server()
    return out


def _serve(dev, cfg, xcfg, params):
    import asyncio

    import numpy as np
    import torch

    from ray_tpu_torch.llm._engine import EngineConfig, PagedEngine
    from ray_tpu_torch.models.llama import forward
    from ray_tpu_torch.ops import flash_attention as fa

    ecfg = EngineConfig(max_num_seqs=4, kv_block_size=16, num_kv_blocks=256,
                        max_model_len=1024)
    eng = PagedEngine(cfg, params, ecfg)
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in SERVE_PROMPTS]
    warm_prompt = rng.randint(0, cfg.vocab_size, size=100).tolist()
    submit, stamps, outs, base = {}, {}, {}, {}

    async def one(i):
        submit[i] = time.monotonic()
        toks, ts = [], []
        async for t in eng.generate_stream(prompts[i],
                                           max_tokens=SERVE_MAX_TOKENS):
            ts.append(time.monotonic())
            toks.append(t)
        outs[i], stamps[i] = toks, ts

    async def main():
        # warm-up: the engine's worker thread makes its cuBLAS state here,
        # outside the measured window
        async for _ in eng.generate_stream(warm_prompt, max_tokens=4):
            pass
        base.update(eng.stats())
        cache = base["prefix_cache"]
        base["misses"] = cache["misses"] if cache is not None else 0
        fa.flash_fwd_launches = 0
        base["t0"] = time.monotonic()
        tasks = [asyncio.create_task(one(i)) for i in range(3)]
        # the last request arrives mid-decode
        while eng.steps == base["steps"] and not all(t.done() for t in tasks):
            await asyncio.sleep(0.001)
        tasks.append(asyncio.create_task(one(3)))
        await asyncio.gather(*tasks)
        base["wall"] = time.monotonic() - base["t0"]

    asyncio.run(main())
    launches = fa.flash_fwd_launches
    st = eng.stats()
    cache = st["prefix_cache"]
    full_prefills = (cache["misses"] - base["misses"] if cache is not None
                     else len(prompts))
    wall = base["wall"]
    n_tokens = sum(len(o) for o in outs.values())
    ttft = {SERVE_PROMPTS[i]: stamps[i][0] - submit[i] for i in stamps}
    itl = [(ts[-1] - ts[0]) / (len(ts) - 1) for ts in stamps.values()
           if len(ts) > 1]
    serve = dict(requests=len(prompts), prompt_tokens=list(SERVE_PROMPTS),
                 tokens_out=n_tokens, wall_s=wall,
                 tokens_per_s=n_tokens / wall, ttft_s=ttft,
                 ttft_p50_s=sorted(ttft.values())[len(ttft) // 2],
                 mean_inter_token_ms=1e3 * sum(itl) / len(itl),
                 decode_steps=st["steps"] - base["steps"],
                 mid_decode_admissions=(st["mid_decode_admissions"]
                                        - base["mid_decode_admissions"]),
                 free_blocks=st["free_blocks"],
                 blocks_in_use=st["blocks_in_use"],
                 full_prefills=full_prefills, k1_launches=launches)
    _check(all(len(outs.get(i, [])) == SERVE_MAX_TOKENS
               for i in range(len(prompts))),
           f"not every request got {SERVE_MAX_TOKENS} tokens: "
           f"{ {i: len(o) for i, o in outs.items()} }")
    # every first token is the plain-attention forward's argmax; the top-1
    # margin of that forward says how far bf16 noise is from a flip
    margins = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            ref = forward(xcfg, params, torch.tensor([p], device=dev))[0, -1]
            top2 = torch.topk(ref, 2).values
            margins.append(float(top2[0] - top2[1]))
            want = int(torch.argmax(ref))
            _check(outs[i][0] == want,
                   f"request {i} ({len(p)} tokens): first token "
                   f"{outs[i][0]} != xla forward argmax {want} (top-1 "
                   f"margin {margins[-1]:.4f}, engine token's logit "
                   f"{float(ref[outs[i][0]]):.4f} vs {float(top2[0]):.4f})")
    serve["first_token_top1_margins"] = margins
    serve["decode_profile"] = _decode_profile(eng, dev)
    print(json.dumps({"serve": serve}), flush=True)
    _check(serve["mid_decode_admissions"] >= 1, "no mid-decode admission")
    _check(st["free_blocks"] == ecfg.num_kv_blocks
           and st["blocks_in_use"] == 0, f"KV blocks leaked: {st}")
    _check(launches == cfg.n_layers * full_prefills,
           f"K1 launches {launches} != {cfg.n_layers} x {full_prefills} "
           f"full prefills")
    return serve


def _decode_profile(eng, dev, n_steps: int = 4):
    """One full-batch decode step (4 active slots at the served prompts'
    lengths): host wall time against the device time of its kernels
    (torch.profiler), so the device's idle share and kernels per step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    B = eng.ecfg.max_num_seqs
    tables = torch.arange(1, 1 + B * eng.max_blocks, device=dev).reshape(
        B, eng.max_blocks)
    lens = torch.tensor(SERVE_PROMPTS, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    last = torch.zeros(B, dtype=torch.long, device=dev)
    temps, gens = np.zeros(B, np.float32), [None] * B

    def step():
        eng._decode(eng.params, eng.kc, eng.vc, tables, lens, active, last,
                    gens, temps)
        torch.cuda.synchronize()

    with torch.no_grad():
        step()
        t = time.monotonic()
        for _ in range(n_steps):
            step()
        host_ms = (time.monotonic() - t) * 1e3 / n_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                step()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(host_ms_per_step=host_ms,
               device_ms_per_step=dev_ms if dev_ms > 0 else "not measured",
               kernels_per_step=sum(e.count for e in kernels) / n_steps,
               top_kernels_ms_per_step={
                   e.key[:60]: e.self_device_time_total / 1e3 / n_steps
                   for e in top})
    if dev_ms > 0:
        out["device_idle_share"] = 1.0 - dev_ms / host_ms
    return out


def _llm_server():
    import torch

    from ray_tpu_torch.llm import LLMConfig, LLMServer

    server = LLMServer(LLMConfig(
        model_id="llama3-8b-random", model="llama3_8b",
        model_overrides={"param_dtype": torch.bfloat16}, seed=SEED))
    t = time.monotonic()
    res = server({"prompt": ["The H100 is", "Paged attention"],
                  "max_tokens": 16})
    batch_s = time.monotonic() - t
    t = time.monotonic()
    chunks = list(server({"prompt": "Hello", "max_tokens": 16,
                          "stream": True}))
    stream_s = time.monotonic() - t
    info = dict(batch_choices=len(res["choices"]),
                completion_tokens=res["usage"]["completion_tokens"],
                batch_s=batch_s, stream_chunks=len(chunks),
                stream_s=stream_s,
                finish_reason=chunks[-1]["choices"][0].get("finish_reason"))
    print(json.dumps({"llm_server": info}), flush=True)
    _check(res["object"] == "text_completion" and len(res["choices"]) == 2,
           f"bad batched completion: {res}")
    _check(0 < res["usage"]["completion_tokens"] <= 32,
           f"bad completion token count: {res['usage']}")
    _check(chunks and chunks[-1]["choices"][0].get("finish_reason")
           in ("stop", "length"), f"bad stream: {chunks[-1:]}")
    return info


# the repo's training flagship (bench.py, __graft_entry__.py) at full width
# and depth: 317.2M parameters, hd 128, GQA rep 2
TRAIN_CFG = dict(vocab_size=32000, dim=1024, n_layers=16, n_heads=8,
                 n_kv_heads=4, ffn_dim=4096, max_seq_len=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 10
TRAIN_LR = 1e-4            # bench.py's
TRAIN_REMAT = "dots"       # recomputes K1 in the backward: 2 launches a layer
# flash vs xla, one step at b1 s2048 on the same weights: two correct bf16
# paths differ in rounding only
TOL_LOSS_REL = 1e-2
GRAD_COS_MIN = 0.99


def _train_tokens_np():
    """The train phase's global batch as numpy: TRAIN_BATCH x TRAIN_SEQ
    seeded tokens (the shard, trainer and stages phases train on the
    same)."""
    import numpy as np

    return np.random.RandomState(SEED + 2).randint(
        0, TRAIN_CFG["vocab_size"], size=(TRAIN_BATCH, TRAIN_SEQ))


def _train_tokens(dev):
    """``_train_tokens_np`` on ``dev``."""
    import torch

    return torch.from_numpy(_train_tokens_np()).to(dev)


def _palm_flops_per_token(cfg, seq):
    """bench.py's PaLM-style count: 6N + 12 L dim s."""
    return 6.0 * cfg.num_params() + 12.0 * cfg.n_layers * cfg.dim * seq


def phase_train(dev):
    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import (LlamaConfig, compute_loss,
                                            make_train_step)
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0)
    t0 = time.monotonic()
    state = shard_state(init_state(SEED))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    # one fixed seeded batch, reused every step (as bench.py does)
    tokens = _train_tokens(data_dev)
    state, loss = train_step(state, tokens)  # warm-up: cuBLAS, kernels
    losses = [float(loss)]
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    t = time.monotonic()
    step_losses = []
    for _ in range(TRAIN_STEPS):
        state, loss = train_step(state, tokens)
        step_losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.monotonic() - t) / TRAIN_STEPS
    launches = dict(k1=fa.flash_fwd_launches, k2=fa.flash_bwd_dq_launches,
                    k3=fa.flash_bwd_dkv_launches)
    losses += [float(x) for x in step_losses]
    peak = torch.cuda.max_memory_allocated()
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / dt
    out = dict(
        config=dict(TRAIN_CFG, attention_impl="flash", remat=TRAIN_REMAT,
                    loss_chunk=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    num_params=cfg.num_params(), lr=TRAIN_LR),
        init_s=init_s, losses=losses, step_ms=dt * 1e3,
        tokens_per_s=tokens_per_s,
        mfu_palm=_palm_flops_per_token(cfg, TRAIN_SEQ) * tokens_per_s
        / PEAK_BF16_FLOPS,
        peak_memory_gb=peak / 1e9,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
        launches=launches)
    out["profile"] = _train_profile(train_step, state, tokens)
    out["bwd_call"] = _bwd_call_kernels(dev, cfg)
    _check(all(np.isfinite(losses)), f"train losses not finite: {losses}")
    _check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    n = cfg.n_layers * TRAIN_STEPS
    _check(launches["k2"] == n and launches["k3"] == n,
           f"K2/K3 launched {launches['k2']}/{launches['k3']} times in "
           f"{TRAIN_STEPS} steps, want {cfg.n_layers} per step")
    _check(launches["k1"] == 2 * n,
           f"K1 launched {launches['k1']} times in {TRAIN_STEPS} steps, want "
           f"{cfg.n_layers} x (1 + 1 recompute) per step")

    # flash vs xla: one step's loss and gradients on the trained weights
    params = state[0]
    del state
    torch.cuda.empty_cache()
    one = tokens[:1]
    leaves = [(f"layers.{k}", w) for k, w in params["layers"].items()] + [
        (k, params[k]) for k in ("tok_emb", "norm", "lm_head")]
    grads = {}
    for impl in ("flash", "xla"):
        icfg = LlamaConfig(**TRAIN_CFG, attention_impl=impl)
        loss = compute_loss(icfg, params, one, remat=TRAIN_REMAT,
                            loss_chunk=0)
        g = torch.autograd.grad(loss, [w for _, w in leaves])
        grads[impl] = (float(loss.detach()), g)
    cos = {}
    for (name, _), gf, gx in zip(leaves, grads["flash"][1], grads["xla"][1]):
        cos[name] = torch.nn.functional.cosine_similarity(
            gf.flatten().double(), gx.flatten().double(), dim=0).item()
    lf, lx = grads["flash"][0], grads["xla"][0]
    out["flash_vs_xla"] = dict(tokens=TRAIN_SEQ, loss_flash=lf, loss_xla=lx,
                               loss_rel_diff=abs(lf - lx) / abs(lx),
                               grad_cosine=cos, grad_cosine_min=min(
                                   cos.values()))
    print(json.dumps({"train": out}), flush=True)
    _check(not out["bwd_call"]["delta_pass"],
           f"the flash backward launched kernels besides K2 and K3: "
           f"{out['bwd_call']}")
    _check(abs(lf - lx) <= TOL_LOSS_REL * abs(lx),
           f"flash vs xla loss {lf} vs {lx} beyond {TOL_LOSS_REL} relative")
    _check(min(cos.values()) >= GRAD_COS_MIN,
           f"flash vs xla gradient cosine below {GRAD_COS_MIN}: {cos}")
    return out


def _train_profile(train_step, state, *batch):
    """One train step on ``batch`` under torch.profiler: host wall time
    against the device time of its kernels, so the device's idle share,
    and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        train_step(state, *batch)
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(host_ms=host_ms,
               device_ms=dev_ms if dev_ms > 0 else "not measured",
               kernels=sum(e.count for e in kernels),
               top_kernels_ms={e.key[:60]: e.self_device_time_total / 1e3
                               for e in top},
               # K1 (hattn::attn_fwd), K2, K3 (and their launches) in this step
               flash_kernels={e.key[:60]: [e.self_device_time_total / 1e3,
                                           e.count]
                              for e in kernels
                              if "flash_" in e.key or "attn_fwd" in e.key})
    if dev_ms > 0:
        out["device_idle_share"] = 1.0 - dev_ms / host_ms
    return out


def _bwd_call_kernels(dev, cfg):
    """The CUDA kernels, by name and count, that one flash backward
    (``_flash_bwd_cuda``) launches at the train phase's attention shape
    under torch.profiler: K2 and K3, and in ``delta_pass`` any other (the
    eager rowsum of dO * o, where delta is not computed by K2)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    hd = cfg.dim // cfg.n_heads

    def randn(heads):
        return torch.randn((TRAIN_BATCH, heads, TRAIN_SEQ, hd),
                           generator=gen, device=dev).bfloat16()

    q, g, k, v = (randn(cfg.n_heads), randn(cfg.n_heads),
                  randn(cfg.n_kv_heads), randn(cfg.n_kv_heads))
    o, lse = fa._flash_fwd_cuda(q, k, v, True)
    fa._flash_bwd_cuda(q, k, v, o, lse, g, True)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fa._flash_bwd_cuda(q, k, v, o, lse, g, True)
        torch.cuda.synchronize()
    kernels = {e.key[:80]: e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")}
    if not kernels:
        return dict(kernels="not measured", delta_pass={})
    return dict(kernels=kernels, delta_pass={
        name: n for name, n in kernels.items()
        if "flash_bwd_dq_kernel" not in name
        and "flash_bwd_dkv_kernel" not in name})


# the sequence-parallel path: 4 ranks on the mesh's sp axis. One card takes
# them as 4 processes over a gloo group (NCCL refuses two ranks on one
# GPU), with every collective staged through host memory: the kernels and
# the ring run on the card at full width, but the ranks time-slice it, so
# a time here is no speed of the ring.
RING_SP = 4
RING_LABEL = "4 ranks time-sliced on one card, gloo through host"
RING_ATTN = (1, 8, 4, 32768, 128)  # b, h, kvh, s, hd: the flagship's heads
RING_ATTN_IMPLS = ("ring", "ulysses", "flash")
RING_TRAIN_BATCH, RING_TRAIN_SEQ, RING_TRAIN_STEPS = 1, 8192, 3
# the flagship's ring training at full width and 4 of its 16 layers (a
# depth cut for chip_smoke's time budget; the train phase runs all 16)
RING_TRAIN_LAYERS = 4
RING_TRAIN_CFG = dict(TRAIN_CFG, n_layers=RING_TRAIN_LAYERS)
RING_TIMEOUT_S = 600
GLOO_TIMEOUT_S = 300


def _ring_attention_inputs(dev):
    """The seeded global bf16 q, k, v, dO (b, s, h, hd) of the attention
    check: the same tensors in every process on the card."""
    import torch

    b, h, kvh, s, hd = RING_ATTN
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    return tuple(torch.randn((b, s, n, hd), generator=gen, device=dev)
                 .bfloat16() for n in (h, kvh, kvh, h))


def _ring_train_tokens(dev):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.RandomState(SEED + 7).randint(
        0, TRAIN_CFG["vocab_size"],
        size=(RING_TRAIN_BATCH, RING_TRAIN_SEQ))).to(dev)


def _zero_launches(fa):
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = fa.flash_chunk_launches = 0


def _read_launches(fa):
    return dict(k1=fa.flash_fwd_launches, k2=fa.flash_bwd_dq_launches,
                k3=fa.flash_bwd_dkv_launches, k4=fa.flash_chunk_launches)


def _errors_against(got, want):
    """What the parent needs to hold a shard against its reference: max
    |err|, max |ref|, the sums of squares, and K1's output rule."""
    got, want = got.float(), want.float()
    err = got - want
    return dict(max_err=err.abs().max().item(),
                max_ref=want.abs().max().item(),
                sq_err=err.square().sum().item(),
                sq_ref=want.square().sum().item(),
                o_rule=bool((err.abs() <= TOL_O + TOL_O_REL * want.abs())
                            .all()),
                finite=bool(got.isfinite().all()))


def _ring_rank_attention(dev, mesh, impl):
    """``impl``'s sharded attention forward and backward on this rank's
    shard of the seeded inputs (causal), launches counted from zero around
    it; then this shard of the whole-sequence ``flash_attention`` (K1, K2,
    K3) on the same inputs, to hold it against. "flash" is the model's
    ``attention`` with ``attention_impl="flash"`` on the sp mesh: the
    kernels on the all-gathered sequence."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, attention
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.mesh import axis_index
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    def flash_on_sp(q, k, v, mesh, causal):
        return attention(LlamaConfig(attention_impl="flash"), q, k, v, mesh)

    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded, "flash": flash_on_sp}[impl]
    q, k, v, g = _ring_attention_inputs(dev)
    n = q.shape[1] // RING_SP
    idx = axis_index(mesh, "sp")
    cut = slice(idx * n, (idx + 1) * n)
    qs, ks, vs = (t[:, cut].contiguous().requires_grad_() for t in (q, k, v))
    torch.cuda.synchronize()
    _zero_launches(fa)
    t = time.monotonic()
    out = fn(qs, ks, vs, mesh, causal=True)
    out.backward(g[:, cut].contiguous())
    torch.cuda.synchronize()
    ms = (time.monotonic() - t) * 1e3
    launches = _read_launches(fa)
    qf, kf, vf = (t.detach().requires_grad_() for t in (q, k, v))
    ref = flash_attention(qf, kf, vf, causal=True)
    ref.backward(g)
    return dict(ms=ms, launches=launches, errors={
        name: _errors_against(x, w[:, cut]) for name, x, w in (
            ("out", out, ref), ("dq", qs.grad, qf.grad),
            ("dk", ks.grad, kf.grad), ("dv", vs.grad, vf.grad))})


def _ring_rank_train(dev, mesh):
    """``make_train_step`` on the flagship with "ring" on the sp mesh: one
    warm-up step, then RING_TRAIN_STEPS with the launches counted from
    zero."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = LlamaConfig(**RING_TRAIN_CFG, attention_impl="ring")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, mesh, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _ring_train_tokens(data_dev)
    state, loss = train_step(state, tokens)  # warm-up
    losses = [float(loss)]
    torch.cuda.synchronize()
    _zero_launches(fa)
    t = time.monotonic()
    for _ in range(RING_TRAIN_STEPS):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
    torch.cuda.synchronize()
    return dict(losses=losses, launches=_read_launches(fa),
                step_ms=(time.monotonic() - t) * 1e3 / RING_TRAIN_STEPS,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def _ring_rank(dev, mesh):
    """One rank of the sp mesh: the attention checks, then the training
    run."""
    import torch

    out = {impl: _ring_rank_attention(dev, mesh, impl)
           for impl in RING_ATTN_IMPLS}
    torch.cuda.empty_cache()
    out["train"] = _ring_rank_train(dev, mesh)
    return out


def _rank_main(rank, world, store, device, mesh_axes, work, args, results):
    """One rank process of a multi-rank phase on ``device`` (every rank on
    the one card): joins the gloo group of ``world`` ranks, builds
    ``MeshSpec(**mesh_axes)``, runs ``work(dev, mesh, *args)`` and puts its
    result (or its traceback) on ``results``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec

    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        mesh = MeshSpec(**mesh_axes).build()
        results.put((rank, True, work(dev, mesh, *args)))
    except Exception:  # the parent fails the run with this traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(dev, name, mesh_axes, work, *args):
    """``work(dev, mesh, *args)`` in one process a position of
    ``MeshSpec(**mesh_axes)``, all on the card ``dev``: their results in
    rank order. A rank that fails, or no result within
    ``RING_TIMEOUT_S``, fails the run; every process is ended before this
    returns."""
    import multiprocessing
    import queue
    import shutil
    import tempfile

    world = math.prod(mesh_axes.values())
    ctx = multiprocessing.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, os.path.join(store_dir, "store"), str(dev), mesh_axes,
        work, args, results)) for r in range(world)]
    for p in procs:
        p.start()
    ranks, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=RING_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"no result in {RING_TIMEOUT_S} s")
                break
            if ok:
                ranks[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(store_dir, ignore_errors=True)
    _check(not errors, f"{name} phase: a rank failed:\n" + "\n".join(errors))
    return [ranks[r] for r in range(world)]


def _flash_train_losses(dev):
    """The single-process reference: the same seed, batch and steps with
    attention_impl="flash"."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step

    cfg = LlamaConfig(**RING_TRAIN_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _ring_train_tokens(data_dev)
    losses = []
    for _ in range(1 + RING_TRAIN_STEPS):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
    del state
    torch.cuda.empty_cache()
    return losses


def phase_ring(dev):
    """The sequence-parallel path on 4 ranks (``RING_LABEL``): ring,
    Ulysses and the model's "flash" attention on the mesh at full width
    against the whole-sequence flash attention, K1-K4 launches counted;
    then the flagship trained on sp 4 with "ring" against a single-process
    "flash" run."""
    import numpy as np

    flash_losses = _flash_train_losses(dev)
    t0 = time.monotonic()
    ranks = _run_ranks(dev, "ring", dict(sp=RING_SP), _ring_rank)
    out = dict(label=RING_LABEL, ranks=RING_SP, wall_s=time.monotonic() - t0)

    b, h, kvh, s, hd = RING_ATTN
    for impl in RING_ATTN_IMPLS:
        per = [ranks[r][impl] for r in range(RING_SP)]
        launches = {k: sum(p["launches"][k] for p in per)
                    for k in per[0]["launches"]}
        row = dict(shape=dict(b=b, h=h, kvh=kvh, s=s, hd=hd, sp=RING_SP),
                   ms_per_rank=[p["ms"] for p in per], launches=launches,
                   launches_per_rank=[p["launches"] for p in per])
        ok = True
        for name in ("out", "dq", "dk", "dv"):
            e = [p["errors"][name] for p in per]
            mx = max(x["max_err"] for x in e)
            rel_norm = (sum(x["sq_err"] for x in e)
                        / sum(x["sq_ref"] for x in e)) ** 0.5
            rel_max = mx / max(x["max_ref"] for x in e)
            row[f"err_{name}"], row[f"rel_norm_{name}"] = mx, rel_norm
            row[f"rel_max_{name}"] = rel_max
            ok = ok and all(x["finite"] for x in e)
            if name == "out":
                ok = ok and all(x["o_rule"] for x in e) \
                    and rel_norm <= TOL_GRAD_NORM
            else:
                ok = ok and rel_norm <= TOL_GRAD_NORM \
                    and rel_max <= TOL_GRAD_MAX
        out[impl] = row
        print(json.dumps({f"ring_attention_{impl}": row}), flush=True)
        _check(ok, f"{impl} attention on sp {RING_SP} disagrees with the "
               f"whole-sequence flash attention beyond K1's rule and "
               f"||err||/||ref|| {TOL_GRAD_NORM} (out) or K2-K3's gates: "
               f"{row}")
        # ring: rank idx runs idx + 1 non-skipped hops each way; Ulysses
        # and "flash" one flash attention a rank
        want = (dict(k1=0, k2=10, k3=10, k4=10) if impl == "ring"
                else dict(k1=RING_SP, k2=RING_SP, k3=RING_SP, k4=0))
        _check(launches == want, f"{impl} launches {launches}, want {want}")

    per = [ranks[r]["train"] for r in range(RING_SP)]
    losses = per[0]["losses"]
    launches = {k: sum(p["launches"][k] for p in per)
                for k in per[0]["launches"]}
    hops = RING_SP * (RING_SP + 1) // 2  # non-skipped hops over the ranks
    layers = RING_TRAIN_CFG["n_layers"]
    train = dict(
        config=dict(RING_TRAIN_CFG, attention_impl="ring", remat=TRAIN_REMAT,
                    loss_chunk=0, batch=RING_TRAIN_BATCH, seq=RING_TRAIN_SEQ,
                    sp=RING_SP, lr=TRAIN_LR),
        losses=losses, flash_losses=flash_losses,
        loss_rel_diff=[abs(a - b) / abs(b)
                       for a, b in zip(losses, flash_losses)],
        step_ms=[p["step_ms"] for p in per], step_ms_label=RING_LABEL,
        peak_memory_gb=[p["peak_memory_gb"] for p in per],
        launches=launches,
        launches_per_step={k: v / RING_TRAIN_STEPS
                           for k, v in launches.items()})
    out["train"] = train
    print(json.dumps({"ring_train": train}), flush=True)
    print(f"ring train step: {max(train['step_ms']):.1f} ms ({RING_LABEL})",
          flush=True)
    _check(all(p["losses"] == losses for p in per),
           f"the ranks disagree on the loss: {[p['losses'] for p in per]}")
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"ring train losses not finite and falling: {losses}")
    _check(max(train["loss_rel_diff"]) <= TOL_LOSS_REL,
           f"ring vs flash losses beyond {TOL_LOSS_REL} relative: {losses} "
           f"vs {flash_losses}")
    # K4 twice a layer and hop (forward and the "dots" recompute), K2 / K3
    # once
    want = dict(k1=0, k2=layers * hops * RING_TRAIN_STEPS,
                k3=layers * hops * RING_TRAIN_STEPS,
                k4=2 * layers * hops * RING_TRAIN_STEPS)
    _check(launches == want, f"ring train launches {launches} in "
           f"{RING_TRAIN_STEPS} steps, want {want}")
    return out


SHARD_MESH = dict(fsdp=2, tp=2)
# the flagship at full width and 8 of its 16 layers in the shard and pipe
# phases and their single-device reference (a depth cut for chip_smoke's
# time budget; the train phase runs all 16): K1/K2/K3 16/8/8 a step a
# shard rank, 2 layers a pipe stage
SHARD_LAYERS = 8
SHARD_CFG = dict(TRAIN_CFG, n_layers=SHARD_LAYERS)
SHARD_LABEL = "4 ranks time-sliced on one card, gloo through host"
SHARD_STEPS = 2            # timed, after one warm-up step
TOL_SHARD_LOSS = 1e-2      # absolute, each step against one device
TOL_SHARD_PARAM = 1e-2     # ||err|| / ||ref|| of each leaf after step one
# ||err|| / ||ref|| of each leaf's step-one gradient: AdamW's first update
# is about sign(g), blind to a gradient scaled by a constant; a gradient
# counted twice (over tp, or over fsdp once too many) gives 1
TOL_SHARD_GRAD = 5e-2
TOL_SHARD_BYTES = 1e-2     # a rank's parameters + moments vs a quarter


def _shard_reference(dev, path):
    """The single-device run the shard and pipe phases are held to:
    "flash" on the same seed, batch, lr and remat, 1 + SHARD_STEPS steps;
    the first step's gradients and the parameters after it saved to
    ``path`` (nested host copies). Returns the losses."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.parallel.mesh import tree_map

    cfg = LlamaConfig(**SHARD_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _train_tokens(data_dev)
    losses = []
    for step in range(1 + SHARD_STEPS):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
        if step == 0:
            torch.save(dict(
                params=tree_map(lambda t: t.detach().cpu(), state[0]),
                grads=tree_map(lambda t: t.grad.cpu(), state[0])), path)
    del state
    torch.cuda.empty_cache()
    return losses


def _shard_rank(dev, mesh, ref_path):
    """One rank of the fsdp 2 x tp 2 mesh: the flagship's train step on
    this rank's shards, one warm-up step (after which its gathered
    gradients and the gathered parameters are held to ``ref_path``'s on
    rank 0) and SHARD_STEPS timed steps with the launches counted from zero
    and the shapes of the attention calls recorded."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import (LlamaConfig, gather_state,
                                            make_train_step, param_specs)
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import gather_full, tree_leaves, tree_map

    shapes = set()

    def recording(launch):
        def wrapped(q, k, *args):
            shapes.add((tuple(q.shape), tuple(k.shape)))
            return launch(q, k, *args)
        return wrapped

    # the kernels' launchers (K1; K2 and K3), as _FlashAttn calls them
    fa._flash_fwd_cuda = recording(fa._flash_fwd_cuda)
    fa._flash_bwd_cuda = recording(fa._flash_bwd_cuda)
    # host seconds, calls and bytes sent (each call's input) in the gloo
    # collectives, on tensors already staged to the host; waiting for a
    # slower peer included
    comm = dict(s=0.0, calls=0, bytes=0)

    def timed(collective, arg):
        def wrapped(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return collective(*args, **kwargs)
            finally:
                comm["s"] += time.monotonic() - t0
                comm["calls"] += 1
                comm["bytes"] += args[arg].numel() * args[arg].element_size()
        return wrapped

    for name, arg in (("all_reduce", 0), ("all_gather", 1),
                      ("all_to_all_single", 1)):
        setattr(dist, name, timed(getattr(dist, name), arg))
    cfg = LlamaConfig(**SHARD_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, mesh, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _train_tokens(data_dev)
    state, loss = train_step(state, tokens)  # warm-up
    losses = [float(loss)]
    params, opt = state
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params)) + sum(
        v.numel() * v.element_size() for moments in opt.state.values()
        for v in moments.values() if torch.is_tensor(v) and v.dim())
    # every rank takes part in both gathers
    full = gather_state(cfg, state, mesh)
    grads = tree_map(lambda t, spec: gather_full(t.grad, spec, mesh),
                     params, param_specs(cfg))
    leaf_errors = grad_errors = None
    if dist.get_rank() == 0:
        ref = torch.load(ref_path, map_location="cpu", mmap=True,
                         weights_only=True)

        def rel_err(got, want):
            want = want.to(got.device)
            return ((got - want).norm() / want.norm()).item()

        leaf_errors = tree_map(rel_err, full, ref["params"])
        grad_errors = tree_map(rel_err, grads, ref["grads"])
    del full, grads
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _zero_launches(fa)
    shapes.clear()
    comm.update(s=0.0, calls=0, bytes=0)
    t = time.monotonic()
    for _ in range(SHARD_STEPS):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
    torch.cuda.synchronize()
    return dict(losses=losses, launches=_read_launches(fa),
                shapes=sorted(shapes),
                step_s=(time.monotonic() - t) / SHARD_STEPS,
                collectives_per_step={k: v / SHARD_STEPS
                                      for k, v in comm.items()},
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                state_bytes=state_bytes, leaf_errors=leaf_errors,
                grad_errors=grad_errors)


def phase_shard(dev, ref):
    """Sharded training on fsdp 2 x tp 2 (``SHARD_LABEL``): the flagship at
    full width and depth with "flash" and remat "dots" on b8 x 2048, each
    rank on its quarter of the parameters and moments, K1-K3 on its 4 of
    the 8 heads and 4 of the 8 rows; held to a single-device "flash" run
    from the same seed on the same batch (``ref``: the path and losses of
    ``_shard_reference``)."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import tree_leaves

    cfg = LlamaConfig(**SHARD_CFG, attention_impl="flash")
    ref_path, ref_losses = ref
    t0 = time.monotonic()
    per = _run_ranks(dev, "shard", SHARD_MESH, _shard_rank, ref_path)
    wall_s = time.monotonic() - t0
    world = math.prod(SHARD_MESH.values())
    rows = TRAIN_BATCH // SHARD_MESH["fsdp"]
    tp = SHARD_MESH["tp"]
    hd = cfg.head_dim
    want_shape = [((rows, cfg.n_heads // tp, TRAIN_SEQ, hd),
                   (rows, cfg.n_kv_heads // tp, TRAIN_SEQ, hd))]
    want_launches = dict(k1=2 * cfg.n_layers * SHARD_STEPS,
                         k2=cfg.n_layers * SHARD_STEPS,
                         k3=cfg.n_layers * SHARD_STEPS, k4=0)
    quarter = 3 * 4 * cfg.num_params() / world  # fp32 parameter + 2 moments
    losses = per[0]["losses"]
    leaf_errors = per[0]["leaf_errors"]
    grad_errors = per[0]["grad_errors"]
    out = dict(
        config=dict(SHARD_CFG, attention_impl="flash", remat=TRAIN_REMAT,
                    loss_chunk=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    lr=TRAIN_LR, mesh=SHARD_MESH),
        label=SHARD_LABEL, wall_s=wall_s, losses=losses,
        flash_losses=ref_losses,
        loss_abs_diff=[abs(a - b) for a, b in zip(losses, ref_losses)],
        leaf_rel_err=leaf_errors, grad_rel_err=grad_errors,
        step_s=[p["step_s"] for p in per],
        collectives_per_step=[p["collectives_per_step"] for p in per],
        peak_memory_gb=[p["peak_memory_gb"] for p in per],
        state_bytes=[p["state_bytes"] for p in per],
        state_frac_of_quarter=[p["state_bytes"] / quarter for p in per],
        launches_per_rank=[p["launches"] for p in per],
        launches_per_rank_step={k: v / SHARD_STEPS
                                for k, v in per[0]["launches"].items()},
        shapes=[p["shapes"] for p in per])
    print(json.dumps({"shard": out}), flush=True)
    print(f"shard train step: {max(out['step_s']):.3f} s, peak memory a "
          f"rank {[round(m, 2) for m in out['peak_memory_gb']]} GB "
          f"({SHARD_LABEL})", flush=True)
    _check(all(p["losses"] == losses for p in per),
           f"the ranks disagree on the loss: {[p['losses'] for p in per]}")
    _check(max(out["loss_abs_diff"]) <= TOL_SHARD_LOSS,
           f"fsdp x tp losses {losses} vs one device {ref_losses}: beyond "
           f"{TOL_SHARD_LOSS}")
    _check(max(tree_leaves(leaf_errors)) <= TOL_SHARD_PARAM,
           f"gathered parameters after one step beyond ||err||/||ref|| "
           f"{TOL_SHARD_PARAM}: {leaf_errors}")
    _check(max(tree_leaves(grad_errors)) <= TOL_SHARD_GRAD,
           f"gathered step-one gradients beyond ||err||/||ref|| "
           f"{TOL_SHARD_GRAD}: {grad_errors}")
    for r, p in enumerate(per):
        _check(p["launches"] == want_launches,
               f"rank {r} launched {p['launches']} in {SHARD_STEPS} steps, "
               f"want {want_launches}")
        _check([tuple(map(tuple, x)) for x in p["shapes"]] == want_shape,
               f"rank {r} ran attention at {p['shapes']}, want {want_shape}")
        _check(abs(p["state_bytes"] / quarter - 1) <= TOL_SHARD_BYTES,
               f"rank {r} holds {p['state_bytes']} bytes of parameters and "
               f"moments, a quarter is {quarter}")
    return out


# GPipe over pp 4: the flagship's 16 layers in 4 stages of 4, 8 microbatches
# of one sequence of the train batch, "flash" without remat; four processes
# on the card over gloo, as in shard (NCCL refuses two ranks on one GPU), so
# its times are time-slicing, not the pipeline's speed
PIPE_MESH = dict(pp=4)
PIPE_MICRO = 8
PIPE_STEPS = 2             # timed, after one warm-up step
PIPE_LABEL = "4 ranks time-sliced on one card, gloo through host"


def _pipe_rank(dev, mesh, ref_path):
    """One stage of the pp 4 mesh: the flagship's pipelined train step on
    its SHARD_LAYERS / 4 layers, one warm-up step (after which its
    gradients and parameters are held to ``ref_path``'s layers of stage
    s, tok_emb,
    norm and lm_head), then PIPE_STEPS timed steps, each with the launches
    counted from zero, the (q, k, causal) of every attention call recorded
    and the bytes this stage sends to its neighbours added up."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import pipeline as tpp
    from ray_tpu_torch.parallel.mesh import AxisRing, axis_index, tree_map

    shapes = set()

    def recording(launch):
        def wrapped(q, k, *args):
            shapes.add((tuple(q.shape), tuple(k.shape), bool(args[-1])))
            return launch(q, k, *args)
        return wrapped

    # the kernels' launchers (K1; K2 and K3), as _FlashAttn calls them
    fa._flash_fwd_cuda = recording(fa._flash_fwd_cuda)
    fa._flash_bwd_cuda = recording(fa._flash_bwd_cuda)
    sent = dict(bytes=0)
    exchange = AxisRing.exchange

    def counted(ring, sends=(), *args, **kwargs):
        sent["bytes"] += sum(t.numel() * t.element_size() for t in sends)
        return exchange(ring, sends, *args, **kwargs)

    AxisRing.exchange = counted
    cfg = LlamaConfig(**SHARD_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = \
        tpp.make_pipeline_train_step(cfg, mesh, PIPE_MICRO,
                                     learning_rate=TRAIN_LR, device=dev)
    state = shard_state(init_state(SEED))
    tokens = _train_tokens(data_dev)
    state, loss = train_step(state, tokens)  # warm-up
    losses = [float(loss)]
    params = state[0]
    stage = axis_index(mesh, "pp")
    per_stage = cfg.n_layers // PIPE_MESH["pp"]
    ref = torch.load(ref_path, map_location="cpu", mmap=True,
                     weights_only=True)

    def rel_err(got, want):
        want = want.to(got.device)
        return ((got - want).norm() / want.norm()).item()

    def own(tree):
        """The reference's leaves as this stage holds them."""
        return dict(tree, layers={
            k: w[stage * per_stage:(stage + 1) * per_stage][None]
            for k, w in tree["layers"].items()})

    leaf_errors = tree_map(lambda t, w: rel_err(t.detach(), w), params,
                           own(ref["params"]))
    grad_errors = tree_map(lambda t, w: rel_err(t.grad, w), params,
                           own(ref["grads"]))
    del ref
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    shapes.clear()
    step_s, launches, step_bytes = [], [], []
    for _ in range(PIPE_STEPS):
        _zero_launches(fa)
        sent["bytes"] = 0
        t = time.monotonic()
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t)
        launches.append(_read_launches(fa))
        step_bytes.append(sent["bytes"])
    return dict(stage=stage, losses=losses, launches=launches,
                shapes=sorted(shapes), step_s=step_s,
                sent_bytes_per_step=step_bytes,
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                leaf_errors=leaf_errors, grad_errors=grad_errors)


def phase_pipe(dev, ref):
    """GPipe over pp 4 (``PIPE_LABEL``): the flagship at full width and
    depth, "flash", no remat, 8 microbatches of one sequence of the b8 x
    2048 train batch, each stage K1-K3 on its 4 layers at (1, 8, 4, 2048,
    128), causal; held to the single-device "flash" run from the same seed
    on the same batch (``ref``: the path and losses of
    ``_shard_reference``)."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import tree_leaves

    cfg = LlamaConfig(**SHARD_CFG, attention_impl="flash")
    ref_path, ref_losses = ref
    t0 = time.monotonic()
    per = _run_ranks(dev, "pipe", PIPE_MESH, _pipe_rank, ref_path)
    wall_s = time.monotonic() - t0
    S, M = PIPE_MESH["pp"], PIPE_MICRO
    mb = TRAIN_BATCH // M
    b, h, kvh, s, hd = PIPE_SHAPE
    want_shapes = [((b, h, s, hd), (b, kvh, s, hd), True)]
    n = cfg.n_layers // S * M
    want_launches = dict(k1=n, k2=n, k3=n, k4=0)
    # an activation forward and its gradient back at each of the S - 1
    # boundaries, for each microbatch, in bf16
    want_bytes = 2 * (S - 1) * M * mb * TRAIN_SEQ * cfg.dim * 2
    losses = per[0]["losses"]
    out = dict(
        config=dict(SHARD_CFG, attention_impl="flash", remat=False,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                    mesh=PIPE_MESH, microbatches=M),
        label=PIPE_LABEL, wall_s=wall_s, losses=losses,
        flash_losses=ref_losses,
        loss_abs_diff=[abs(a - b) for a, b in zip(losses, ref_losses)],
        leaf_rel_err=[p["leaf_errors"] for p in per],
        grad_rel_err=[p["grad_errors"] for p in per],
        step_ms=[[t * 1e3 for t in p["step_s"]] for p in per],
        peak_memory_gb=[p["peak_memory_gb"] for p in per],
        handoff_bytes_per_step=[sum(p["sent_bytes_per_step"][i] for p in per)
                                for i in range(PIPE_STEPS)],
        handoff_bytes_expected=want_bytes,
        bubble_share=(S - 1) / (M + S - 1),
        launches_per_rank_step=[p["launches"] for p in per],
        shapes=[p["shapes"] for p in per])
    print(json.dumps({"pipe": out}), flush=True)
    print(f"pipe train step (ms, each rank): {out['step_ms']}; peak memory a "
          f"rank {[round(m, 2) for m in out['peak_memory_gb']]} GB; hand-off "
          f"{out['handoff_bytes_per_step']} B a step; bubble "
          f"{S - 1}/{M + S - 1} ({PIPE_LABEL})", flush=True)
    _check([p["stage"] for p in per] == list(range(S)),
           f"ranks hold stages {[p['stage'] for p in per]}")
    _check(all(p["losses"] == losses for p in per),
           f"the ranks disagree on the loss: {[p['losses'] for p in per]}")
    _check(max(out["loss_abs_diff"]) <= TOL_SHARD_LOSS,
           f"pp losses {losses} vs one device {ref_losses}: beyond "
           f"{TOL_SHARD_LOSS}")
    for r, p in enumerate(per):
        _check(max(tree_leaves(p["leaf_errors"])) <= TOL_SHARD_PARAM,
               f"rank {r}'s parameters after one step beyond ||err||/||ref|| "
               f"{TOL_SHARD_PARAM}: {p['leaf_errors']}")
        _check(max(tree_leaves(p["grad_errors"])) <= TOL_SHARD_GRAD,
               f"rank {r}'s step-one gradients beyond ||err||/||ref|| "
               f"{TOL_SHARD_GRAD}: {p['grad_errors']}")
        for i, counts in enumerate(p["launches"]):
            _check(counts == want_launches,
                   f"rank {r} launched {counts} in step {i}, want "
                   f"{want_launches}")
        got_shapes = [(tuple(q), tuple(k), c) for q, k, c in p["shapes"]]
        _check(got_shapes == want_shapes,
               f"rank {r} ran attention at {p['shapes']}, want {want_shapes}")
    _check(out["handoff_bytes_per_step"] == [want_bytes] * PIPE_STEPS,
           f"hand-offs of {out['handoff_bytes_per_step']} B a step, want "
           f"{want_bytes}")
    return out


# ViT-B/16 (ViTConfig.base: 86.5M parameters, 224² images, patch 16, 12
# layers, dim 768, 12 heads of 64, MLP 3072, 1000 classes) at full width and
# depth: fp32 parameters, bf16 compute, "flash", no remat, one seeded batch
# of VIT_BATCH NHWC images
VIT_BATCH, VIT_STEPS, VIT_LR = 128, 10, 1e-3  # the JAX package's lr
VIT_CMP_STEPS = 3          # flash against xla: the loss after 3 steps
TOL_VIT_LOSS = 1e-2        # absolute


def _vit_batch(dev, cfg):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    images = torch.randn((VIT_BATCH, cfg.image_size, cfg.image_size,
                          cfg.channels), generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=gen,
                           device=dev)
    return images, labels


def _vit_losses(dev, impl, steps):
    """Losses of ``steps`` AdamW steps of ViT-B/16 with ``impl`` from seed
    SEED on the vit batch."""
    import torch

    from ray_tpu_torch.models.vit import ViTConfig, make_train_step

    cfg = ViTConfig.base(attention_impl=impl)
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=VIT_LR)
    state = shard_state(init_state(SEED))
    images, labels = _vit_batch(data_dev, cfg)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, images, labels)
        losses.append(float(loss))
    del state
    torch.cuda.empty_cache()
    return losses


def phase_vit(dev):
    """ViT-B/16 trained at full width and depth on one card ("flash": K1
    forward, K2 and K3 backward, unmasked, at (128, 12, 12, 196, 64)),
    then held to "xla" on the loss after 3 steps, on the step-one head
    gradients and on the forward of converted weights with a nonzero
    head."""
    import numpy as np
    import torch

    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.vit import (ViTConfig, compute_loss, forward,
                                          init_params, make_train_step)
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import tree_map

    cfg = ViTConfig.base(attention_impl="flash")
    xcfg = ViTConfig.base(attention_impl="xla")
    calls = []

    def recording(launch, kind):
        def wrapped(q, k, v, *args):
            calls.append((kind, tuple(q.shape), tuple(k.shape), args[-1]))
            return launch(q, k, v, *args)
        return wrapped

    # the kernels' launchers as _FlashAttn calls them: (shapes, causal)
    fwd_cuda, bwd_cuda = fa._flash_fwd_cuda, fa._flash_bwd_cuda
    fa._flash_fwd_cuda = recording(fwd_cuda, "k1")
    fa._flash_bwd_cuda = recording(bwd_cuda, "k23")
    try:
        init_state, shard_state, train_step, data_dev = make_train_step(
            cfg, learning_rate=VIT_LR)
        state = shard_state(init_state(SEED))
        images, labels = _vit_batch(data_dev, cfg)
        state, loss = train_step(state, images, labels)  # warm-up
        losses = [float(loss)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches(fa)
        calls.clear()
        t = time.monotonic()
        step_losses = []
        for _ in range(VIT_STEPS):
            state, loss = train_step(state, images, labels)
            step_losses.append(loss)
        torch.cuda.synchronize()
        dt = (time.monotonic() - t) / VIT_STEPS
        launches = _read_launches(fa)
        shapes = sorted(set(calls))
    finally:
        fa._flash_fwd_cuda, fa._flash_bwd_cuda = fwd_cuda, bwd_cuda
    losses += [float(x) for x in step_losses]
    out = dict(
        config=dict(image_size=cfg.image_size, patch_size=cfg.patch_size,
                    dim=cfg.dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                    mlp_dim=cfg.mlp_dim, num_classes=cfg.num_classes,
                    num_params=cfg.num_params(), batch=VIT_BATCH,
                    attention_impl="flash", remat=False, lr=VIT_LR),
        losses=losses, step_ms=dt * 1e3, images_per_s=VIT_BATCH / dt,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches,
        launches_per_step={k: v / VIT_STEPS for k, v in launches.items()},
        shapes=shapes)
    out["profile"] = _train_profile(train_step, state, images, labels)
    del state
    torch.cuda.empty_cache()

    # flash against xla: the loss after VIT_CMP_STEPS steps from the seed
    lf = _vit_losses(dev, "flash", VIT_CMP_STEPS)
    lx = _vit_losses(dev, "xla", VIT_CMP_STEPS)
    # step one from the seed: its gradient reaches the zero head alone
    params = init_params(cfg, SEED)
    for t_ in (params["head"], params["head_bias"]):
        t_.requires_grad_(True)
    grads = {}
    for c in (cfg, xcfg):
        loss = compute_loss(c, params, images, labels)
        grads[c.attention_impl] = torch.autograd.grad(
            loss, [params["head"], params["head_bias"]])
    cos = {name: torch.nn.functional.cosine_similarity(
        gf.flatten().double(), gx.flatten().double(), dim=0).item()
        for name, gf, gx in zip(("head", "head_bias"), grads["flash"],
                                grads["xla"])}
    # converted weights (a nested numpy dict, as a JAX checkpoint arrives)
    # with a seeded nonzero head: the forward phase's top-1 rule
    tree = tree_map(lambda t_: t_.detach().cpu().numpy(), params)
    rng = np.random.RandomState(SEED + 9)
    tree["head"] = (0.02 * rng.randn(cfg.dim, cfg.num_classes)).astype(
        np.float32)
    del params, grads
    conv = params_from_jax(tree, None)
    with torch.no_grad():
        _zero_launches(fa)
        logits_f = forward(cfg, conv, images)
        fwd_launches = fa.flash_fwd_launches
        logits_x = forward(xcfg, conv, images)
    top1 = (logits_f.argmax(-1) == logits_x.argmax(-1)).float().mean().item()
    dls = (torch.log_softmax(logits_f, -1) - torch.log_softmax(logits_x, -1)
           ).abs().max().item()
    finite = bool(torch.isfinite(logits_f).all())
    out["flash_vs_xla"] = dict(
        steps=VIT_CMP_STEPS, losses_flash=lf, losses_xla=lx,
        loss_abs_diff=abs(lf[-1] - lx[-1]), head_grad_cosine=cos,
        forward_top1_agreement=top1, forward_max_abs_logsoftmax_diff=dls,
        forward_k1_launches=fwd_launches)
    del conv, logits_f, logits_x
    torch.cuda.empty_cache()
    print(json.dumps({"vit": out}), flush=True)
    print(f"vit train step: {out['step_ms']:.1f} ms, "
          f"{out['images_per_s']:.0f} images/s, peak "
          f"{out['peak_memory_gb']:.2f} GB", flush=True)
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"vit losses not finite and falling: {losses}")
    n = cfg.n_layers * VIT_STEPS
    _check(launches == dict(k1=n, k2=n, k3=n, k4=0),
           f"vit launched {launches} in {VIT_STEPS} steps, want K1, K2 and "
           f"K3 {cfg.n_layers} a step")
    b, h, kvh, s, hd = VIT_SHAPE
    want = [("k1", (b, h, s, hd), (b, kvh, s, hd), False),
            ("k23", (b, h, s, hd), (b, kvh, s, hd), False)]
    _check(shapes == want, f"vit ran attention at {shapes}, want {want}")
    _check(abs(lf[-1] - lx[-1]) <= TOL_VIT_LOSS,
           f"vit flash vs xla loss after {VIT_CMP_STEPS} steps {lf} vs {lx} "
           f"beyond {TOL_VIT_LOSS}")
    _check(min(cos.values()) >= GRAD_COS_MIN,
           f"vit flash vs xla step-one head gradient cosine below "
           f"{GRAD_COS_MIN}: {cos}")
    _check(finite and fwd_launches == cfg.n_layers and top1 >= TOP1_MIN,
           f"vit forward of converted weights: finite {finite}, K1 "
           f"{fwd_launches} launches, flash vs xla top-1 {top1} < {TOP1_MIN}")
    return out


# Mixtral-8x7B's FFN widths (mistralai/Mixtral-8x7B-v0.1 config.json:
# hidden_size 4096, intermediate_size 14336, 8 local experts, 2 a token) with
# the JAX package's GELU pair for the expert FFN (not SwiGLU); fp32
# parameters, bf16 tokens
MOE_D, MOE_FF, MOE_E, MOE_K = 4096, 14336, 8, 2
MOE_TOKENS, MOE_CF = 4096, 2.0
MOE_EP = dict(tp=4)
MOE_EP_TOKENS, MOE_EP_CF = 1024, 8.0   # no slot dropped
MOE_LABEL = "4 ranks time-sliced on one card, gloo through host"
TOL_MOE = 1e-2             # ||err|| / ||ref||
TOL_COMBINE = 1e-5


def _moe_reference(params, x, top_k, capacity):
    """The MoE FFN token by token: each kept (token, choice) slot's gate
    times its expert's FFN of the token, summed in fp32; a slot is kept
    while its expert has taken fewer than ``capacity`` slots, first choices
    in token order before second ones. Returns (y, dropped slots)."""
    import torch
    import torch.nn.functional as F

    xf = x.float()
    probs = torch.softmax(xf @ params["router"].float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    y = torch.zeros_like(xf)
    taken = [0] * params["router"].shape[1]
    dropped = 0
    for j in range(top_k):
        for e in range(len(taken)):
            toks = (idx[:, j] == e).nonzero()[:, 0]
            keep = toks[:max(0, capacity - taken[e])]
            taken[e] += len(toks)
            dropped += len(toks) - len(keep)
            if len(keep):
                h = F.gelu(xf[keep] @ params["w_in"][e].float(),
                           approximate="tanh")
                y.index_add_(0, keep, gates[keep, j:j + 1]
                             * (h @ params["w_out"][e].float()))
    return y, dropped


def _moe_ep_rank(dev, mesh, ref_path):
    """One rank of ``moe_ffn_ep`` over tp 4: its experts' block of the
    seeded parameters, the whole token batch (tokens_spec P("dp"), dp 1):
    y, aux and the gradients of mean(y²) against the single shard's in
    ``ref_path`` (sums of squares, for the parent to combine), and the
    ms of a forward call."""
    import torch

    from ray_tpu_torch.parallel.mesh import shard_of
    from ray_tpu_torch.parallel.moe import (init_moe_params, moe_ffn_ep,
                                            moe_param_specs)

    specs = moe_param_specs("tp")
    full = init_moe_params(SEED, MOE_D, MOE_FF, MOE_E, device=dev)
    params = {k: shard_of(v, specs[k], mesh).clone().requires_grad_()
              for k, v in full.items()}
    del full
    x = _moe_tokens(dev, MOE_EP_TOKENS)
    y, aux = moe_ffn_ep(params, x, mesh=mesh, axis="tp", top_k=MOE_K,
                        capacity_factor=MOE_EP_CF)
    y.float().square().mean().backward()
    ref = torch.load(ref_path, map_location="cpu", mmap=True,
                     weights_only=True)
    errors = {"y": _errors_against(y, ref["y"].to(dev))}
    for k in params:
        errors[k] = _errors_against(params[k].grad, shard_of(
            ref["grads"][k], specs[k], mesh).to(dev))
    del ref
    with torch.no_grad():
        for _ in range(2):  # warm-up
            moe_ffn_ep(params, x, mesh=mesh, axis="tp", top_k=MOE_K,
                       capacity_factor=MOE_EP_CF)
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(3):
            moe_ffn_ep(params, x, mesh=mesh, axis="tp", top_k=MOE_K,
                       capacity_factor=MOE_EP_CF)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t) * 1e3 / 3
    return dict(errors=errors, aux=float(aux.detach()), ms=ms,
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def _moe_tokens(dev, n):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    return torch.randn((n, MOE_D), generator=gen, device=dev).bfloat16()


def phase_moe(dev):
    """``moe_ffn`` at Mixtral-8x7B's FFN widths on MOE_TOKENS bf16 tokens
    against a per-token reference on the card; then ``moe_ffn_ep`` over tp
    4 (MOE_LABEL) against the single shard's outputs and gradients."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.parallel.moe import (_capacity, _route,
                                            init_moe_params, moe_ffn)

    params = init_moe_params(SEED, MOE_D, MOE_FF, MOE_E)
    x = _moe_tokens(dev, MOE_TOKENS)
    capacity = _capacity(MOE_TOKENS, MOE_E, MOE_CF, MOE_K)
    with torch.no_grad():
        y, aux = moe_ffn(params, x, top_k=MOE_K, capacity_factor=MOE_CF)
        ref, ref_dropped = _moe_reference(params, x, MOE_K, capacity)
        dispatch, combine, _ = _route(x.float() @ params["router"], MOE_K,
                                      capacity)
        slots = dispatch.sum(dim=(1, 2))
        dropped = int(round(MOE_TOKENS * MOE_K - slots.sum().item()))
        whole = slots == MOE_K   # tokens that kept every slot
        combine_err = (combine.sum(dim=(1, 2))[whole] - 1).abs().max().item()
        del dispatch, combine
        rel = ((y.float() - ref).norm() / ref.norm()).item()
        ms = _time_ms(lambda: moe_ffn(params, x, top_k=MOE_K,
                                      capacity_factor=MOE_CF),
                      iters=5, warmup=1)
    out = dict(config=dict(d_model=MOE_D, d_ff=MOE_FF, experts=MOE_E,
                           top_k=MOE_K, tokens=MOE_TOKENS,
                           capacity_factor=MOE_CF, capacity=capacity),
               rel_err=rel, aux=float(aux), dropped_slots=dropped,
               reference_dropped_slots=ref_dropped,
               tokens_with_every_slot=int(whole.sum()),
               combine_sum_max_err=combine_err, ms=ms,
               tokens_per_s=MOE_TOKENS / (ms * 1e-3))
    del y, ref

    # the single shard at the ep check's tokens and capacity: y and the
    # gradients of mean(y²), which the ranks are held to
    xe = _moe_tokens(dev, MOE_EP_TOKENS)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    ye, _ = moe_ffn(leaves, xe, top_k=MOE_K, capacity_factor=MOE_EP_CF)
    ye.float().square().mean().backward()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_ref_")
    try:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save(dict(y=ye.detach(), grads={k: v.grad for k, v in
                                              leaves.items()}), ref_path)
        del params, leaves, ye, xe
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        per = _run_ranks(dev, "moe", MOE_EP, _moe_ep_rank, ref_path)
        wall_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ep = MOE_EP["tp"]
    ep_capacity = _capacity(MOE_EP_TOKENS, MOE_E, MOE_EP_CF, MOE_K)
    ep_out = dict(label=MOE_LABEL, mesh=MOE_EP, tokens=MOE_EP_TOKENS,
                  capacity_factor=MOE_EP_CF, capacity=ep_capacity,
                  wall_s=wall_s, ms_per_call=[p["ms"] for p in per],
                  tokens_per_s=[MOE_EP_TOKENS / (p["ms"] * 1e-3)
                                for p in per],
                  # each all-to-all moves a rank's fp32 [E, C, d] buckets,
                  # (ep - 1)/ep of them to other ranks; two a call
                  exchange_bytes_per_rank=4 * MOE_E * ep_capacity * MOE_D,
                  peak_memory_gb=[p["peak_memory_gb"] for p in per],
                  aux=[p["aux"] for p in per])
    ok = True
    for name in ("y", "router", "w_in", "w_out"):
        e = [p["errors"][name] for p in per]
        if name == "router":  # every rank holds the whole router
            e = e[:1]
        rel_norm = (sum(x_["sq_err"] for x_ in e)
                    / sum(x_["sq_ref"] for x_ in e)) ** 0.5
        ep_out[f"rel_norm_{name}"] = rel_norm
        ok = ok and rel_norm <= TOL_MOE and all(x_["finite"] for x_ in e)
    out["ep"] = ep_out
    print(json.dumps({"moe": out}), flush=True)
    print(f"moe_ffn at Mixtral-8x7B widths: {ms:.2f} ms a call, "
          f"{out['tokens_per_s']:.0f} tokens/s; moe_ffn_ep over tp {ep}: "
          f"{max(ep_out['ms_per_call']):.1f} ms a call ({MOE_LABEL})",
          flush=True)
    _check(rel <= TOL_MOE, f"moe_ffn vs the per-token reference: "
           f"||err||/||ref|| {rel} > {TOL_MOE}")
    _check(combine_err <= TOL_COMBINE,
           f"combine weights of tokens that kept every slot sum to 1 +- "
           f"{combine_err} > {TOL_COMBINE}")
    _check(dropped == ref_dropped, f"moe_ffn dropped {dropped} slots, the "
           f"reference {ref_dropped}")
    _check(ok, f"moe_ffn_ep over tp {ep} vs the single shard beyond "
           f"||err||/||ref|| {TOL_MOE}: {ep_out}")
    return out


# Checkpoints of the shard phase's state (train/_checkpoint.py): the
# flagship on fsdp 2 x tp 2, four processes on the card over gloo, as in
# shard; the write runs on a background thread while the next step runs
CKPT_MESH = SHARD_MESH
CKPT_LABEL = "4 ranks time-sliced on one card, gloo through host"
# the flagship at full width and 4 of its 16 layers (the depth cut keeps
# the phase inside chip_smoke's time budget; the shard phase runs all 16):
# K1/K2/K3 8/4/4 a restored step
CKPT_LAYERS = 4
CKPT_CFG = dict(TRAIN_CFG, n_layers=CKPT_LAYERS)
TOL_CKPT_LOSS_REL = 1e-6   # same-world step-2 loss against the uninterrupted


def _tree_bytes(tree) -> int:
    """Bytes of a train-state tree's tensors: what a snapshot copies."""
    import torch

    from ray_tpu_torch.train._checkpoint import _flatten_with_paths

    return sum(t.numel() * t.element_size()
               for t in _flatten_with_paths(tree).values()
               if torch.is_tensor(t))


def _ckpt_rank(dev, mesh, root, ref_path):
    """One rank of the fsdp 2 x tp 2 mesh: the flagship's step 1, a save of
    its train state (``AsyncCheckpointWriter`` into the staging dir of a
    ``CheckpointManager``, rank 0 finalizing with 4 ranks) and step 2
    while the write runs; then a same-world restore (``load_state``) into
    a fresh state (``init_state(SEED + 1)``), held bitwise to what was
    saved, and step 2 from it with the launches counted from zero. Rank 0
    saves the gathered parameters after the uninterrupted step 2 to
    ``ref_path``."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import (LlamaConfig, gather_state,
                                            make_train_step, param_specs)
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import tree_map
    from ray_tpu_torch.train import (AsyncCheckpointWriter, Checkpoint,
                                     CheckpointManager, load_train_state,
                                     train_state_specs, train_state_tree)
    from ray_tpu_torch.train._checkpoint import _flatten_with_paths

    rank = dist.get_rank()
    cfg = LlamaConfig(**CKPT_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, mesh, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    specs = train_state_specs(param_specs(cfg))
    tokens = _train_tokens(data_dev)
    state = shard_state(init_state(SEED))
    state, loss = train_step(state, tokens)
    losses = [float(loss)]
    tree = train_state_tree(*state)
    nbytes = _tree_bytes(tree)
    # what the save must write, kept on the card for the bitwise check
    saved = {k: v.detach().clone()
             for k, v in _flatten_with_paths(tree).items()}
    mgr = CheckpointManager(root, "ckpt", num_to_keep=1)
    writer = AsyncCheckpointWriter()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fut = writer.save(tree, mgr.staging_dir(1), rank=rank, specs=specs,
                      mesh=mesh, manifest={"metrics": {"step": 1}})
    t_saved = time.monotonic()
    in_flight = not fut.done()
    done = []
    fut.add_done_callback(lambda _: done.append(time.monotonic()))
    del tree
    state, loss = train_step(state, tokens)  # while the write runs
    losses.append(float(loss))
    fut.result()
    dist.barrier()  # every rank file written
    finalized = None
    if rank == 0:
        ckpt = mgr.finalize(1, {"loss": losses[0]}, expected_ranks=4)
        finalized = ckpt and ckpt.path
    full = tree_map(lambda t: t.cpu(), gather_state(cfg, state, mesh))
    if rank == 0:
        torch.save(full, ref_path)
    del full
    dist.barrier()
    final = mgr.final_dir(1)
    fresh = shard_state(init_state(SEED + 1))
    torch.cuda.synchronize()
    t1 = time.monotonic()
    load_train_state(Checkpoint(final).load_state(
        train_state_tree(*fresh), rank, specs, mesh), *fresh)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t1
    restored = _flatten_with_paths(train_state_tree(*fresh))
    bitwise = restored.keys() == saved.keys() and all(
        torch.equal(restored[k].to(saved[k].device), saved[k])
        for k in saved)
    count = int(restored["/1/0/0"])
    del saved, restored, state
    torch.cuda.empty_cache()
    _zero_launches(fa)
    fresh, loss = train_step(fresh, tokens)
    torch.cuda.synchronize()
    return dict(losses=losses, restored_loss=float(loss),
                launches=_read_launches(fa), bitwise=bitwise, count=count,
                bytes=nbytes, save_s=t_saved - t0,
                write_s=done[0] - t_saved, in_flight=in_flight,
                load_s=load_s, finalized=finalized)


def _resident_bytes() -> int:
    """This process's resident set: /proc/self/statm's second field."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _peak_resident(fn):
    """``fn()``, and the largest resident set of this process seen while
    it ran, sampled every 10 ms on a thread (getrusage's ru_maxrss keeps
    the parent's peak across fork and exec, and the card's machine gives
    no VmHWM)."""
    import threading

    peak = [_resident_bytes()]
    done = threading.Event()

    def sample():
        while not done.wait(0.01):
            peak[0] = max(peak[0], _resident_bytes())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        out = fn()
    finally:
        done.set()
        t.join()
    return out, max(peak[0], _resident_bytes())


def _ckpt_consolidate(dev, mesh, root, ref_path):
    """The cross-world restore in a process of its own: the checkpoint of
    4 ranks into a single-device state (``load_consolidated``), step 2
    from it with the launches counted from zero, and its parameters held
    to the gathered sharded ones (``ref_path``). Host memory: this
    process's resident set before the restore and its peak through it."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import tree_map
    from ray_tpu_torch.train import (Checkpoint, load_train_state,
                                     train_state_tree)

    cfg = LlamaConfig(**CKPT_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED + 1))
    torch.cuda.synchronize()
    rss_before = _resident_bytes()
    t0 = time.monotonic()
    tree, rss_peak = _peak_resident(lambda: Checkpoint(
        root).load_consolidated(train_state_tree(*state)))
    load_train_state(tree, *state)
    del tree
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    count = int(train_state_tree(*state)[1][0][0])
    _zero_launches(fa)
    state, loss = train_step(state, _train_tokens(data_dev))
    torch.cuda.synchronize()
    launches = _read_launches(fa)
    ref = torch.load(ref_path, map_location="cpu", mmap=True,
                     weights_only=True)

    def rel_err(got, want):
        want = want.to(got.device)
        return ((got.detach() - want).norm() / want.norm()).item()

    return dict(loss=float(loss), launches=launches, count=count,
                load_s=load_s, rss_before=rss_before, rss_peak=rss_peak,
                leaf_errors=tree_map(rel_err, state[0], ref))


def phase_ckpt(dev):
    """Checkpoints of the flagship's sharded train state at full width and
    CKPT_LAYERS layers (``CKPT_LABEL``): save while the next step runs, a same-world
    restore held bitwise and to the uninterrupted step 2, and a
    cross-world restore into one device held to the shard phase's
    tolerances."""
    try:
        import fsspec  # noqa: F401  (the storage plane's filesystems)
    except ImportError as e:
        _fail(f"ckpt phase: fsspec is missing: {e}")
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import tree_leaves

    cfg = LlamaConfig(**CKPT_CFG, attention_impl="flash")
    world = math.prod(CKPT_MESH.values())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ref_path = os.path.join(tmp, "step2_params.pt")
        t0 = time.monotonic()
        per = _run_ranks(dev, "ckpt", CKPT_MESH, _ckpt_rank, tmp, ref_path)
        final = per[0]["finalized"]
        _check(final is not None, "ckpt phase: rank 0 did not finalize")
        one = _run_ranks(dev, "ckpt1", {}, _ckpt_consolidate, final,
                         ref_path)[0]
        wall_s = time.monotonic() - t0
        files = sorted(os.listdir(final))
        file_bytes = sum(os.path.getsize(os.path.join(final, f))
                         for f in files if f.startswith("rank_"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = sum(p["bytes"] for p in per)
    l2 = per[0]["losses"][1]
    want_launches = dict(k1=2 * cfg.n_layers, k2=cfg.n_layers,
                         k3=cfg.n_layers, k4=0)
    gb = 1e9
    out = dict(
        config=dict(CKPT_CFG, attention_impl="flash", remat=TRAIN_REMAT,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                    mesh=CKPT_MESH),
        label=CKPT_LABEL, wall_s=wall_s, files=files,
        losses=per[0]["losses"],
        restored_losses=[p["restored_loss"] for p in per],
        restored_loss_rel=abs(per[0]["restored_loss"] - l2) / abs(l2),
        one_device_loss=one["loss"], one_device_loss_diff=abs(
            one["loss"] - l2),
        one_device_leaf_rel_err=one["leaf_errors"],
        bitwise=[p["bitwise"] for p in per],
        counts=[p["count"] for p in per] + [one["count"]],
        launches_per_rank=[p["launches"] for p in per],
        launches_one_device=one["launches"],
        bytes_per_rank=[p["bytes"] for p in per], bytes_total=total,
        file_bytes_total=file_bytes,
        save_blocking_s=[p["save_s"] for p in per],
        write_s=[p["write_s"] for p in per],
        write_gb_per_s=[p["bytes"] / p["write_s"] / gb for p in per],
        write_in_flight_at_step2=[p["in_flight"] for p in per],
        load_state_s=[p["load_s"] for p in per],
        load_state_gb_per_s=[p["bytes"] / p["load_s"] / gb for p in per],
        load_consolidated_s=one["load_s"],
        load_consolidated_gb_per_s=total / one["load_s"] / gb,
        consolidating_rss_before_gb=one["rss_before"] / gb,
        consolidating_rss_peak_gb=one["rss_peak"] / gb)
    print(json.dumps({"ckpt": out}), flush=True)
    print(f"ckpt: {out['bytes_per_rank'][0] / gb:.4f} GB a rank, "
          f"{total / gb:.4f} GB in all; save blocks "
          f"{max(out['save_blocking_s']):.3f} s, write "
          f"{max(out['write_s']):.3f} s "
          f"({min(out['write_gb_per_s']):.3f} GB/s a rank); load_state "
          f"{max(out['load_state_s']):.3f} s "
          f"({min(out['load_state_gb_per_s']):.3f} GB/s); "
          f"load_consolidated {one['load_s']:.3f} s "
          f"({out['load_consolidated_gb_per_s']:.3f} GB/s), peak host "
          f"memory {out['consolidating_rss_peak_gb']:.2f} GB ({CKPT_LABEL})",
          flush=True)
    _check(len([f for f in files if f.startswith("rank_")]) == world,
           f"ckpt: the checkpoint holds {files}, want {world} rank files")
    _check(all(out["write_in_flight_at_step2"]),
           f"ckpt: a write had landed before step 2 began: "
           f"{out['write_in_flight_at_step2']}")
    _check(all(out["bitwise"]), f"ckpt: a restored block differs from the "
           f"saved one: {out['bitwise']}")
    _check(out["counts"] == [1] * (world + 1),
           f"ckpt: restored step counts {out['counts']}, want 1")
    _check(all(math.isfinite(x) for x in out["losses"]
               + out["restored_losses"] + [one["loss"]]),
           f"ckpt: a loss is not finite: {out}")
    _check(all(abs(x - l2) <= TOL_CKPT_LOSS_REL * abs(l2)
               for x in out["restored_losses"]),
           f"ckpt: same-world step-2 losses {out['restored_losses']} vs "
           f"{l2}: beyond {TOL_CKPT_LOSS_REL} relative")
    _check(out["one_device_loss_diff"] <= TOL_SHARD_LOSS,
           f"ckpt: one-device step-2 loss {one['loss']} vs {l2}: beyond "
           f"{TOL_SHARD_LOSS}")
    _check(max(tree_leaves(one["leaf_errors"])) <= TOL_SHARD_PARAM,
           f"ckpt: one-device parameters after step 2 beyond "
           f"||err||/||ref|| {TOL_SHARD_PARAM}: {one['leaf_errors']}")
    for r, p in enumerate(per):
        _check(p["launches"] == want_launches,
               f"ckpt: rank {r} launched {p['launches']} on its restored "
               f"step, want {want_launches}")
    _check(one["launches"] == want_launches,
           f"ckpt: one device launched {one['launches']} on its restored "
           f"step, want {want_launches}")
    return out


# The rllib learners (rllib/) on the card: each at its own default widths
# on a seeded batch of a realistic size, 20 updates on CUDA against the
# same learner on the CPU from the same weights and batches (and, for SAC,
# the same noise); fp32 products stay fp32 (TF32 off, torch's default)
RL_UPDATES = 20
RL_ROWS = 256
RL_PPO_ROWS = 4096          # minibatch 128, 4 epochs (its defaults)
RL_OBS, RL_ACTIONS, RL_ACT_DIM = 8, 4, 2
TOL_RL = 1e-4


def _rl_batch(seed):
    """Every column a learner reads, seeded: RL_ROWS rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = RL_ROWS
    term = (rng.random(n) < 0.05).astype(np.float32)
    actions = rng.integers(0, RL_ACTIONS, n)
    return dict(
        obs=rng.normal(size=(n, RL_OBS)).astype(np.float32),
        next_obs=rng.normal(size=(n, RL_OBS)).astype(np.float32),
        actions=actions.astype(np.int32), action=actions.astype(np.int64),
        logp=rng.normal(-1.4, 0.1, n).astype(np.float32),
        rewards=rng.normal(size=n).astype(np.float32),
        reward=rng.normal(size=n).astype(np.float32),
        terminated=term,
        cut=np.maximum(term, rng.random(n) < 0.05).astype(np.float32),
        cont_actions=np.tanh(rng.normal(size=(n, RL_ACT_DIM))).astype(
            np.float32),
        bc_targets=rng.normal(size=(n, RL_ACTIONS)).astype(np.float32))


def _rl_cases():
    """name -> (learner class name, constructor args, keywords, the
    arguments of update i)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    n = RL_PPO_ROWS
    ppo = dict(obs=rng.normal(size=(n, RL_OBS)).astype(np.float32),
               actions=rng.integers(0, RL_ACTIONS, n).astype(np.int32),
               logp=rng.normal(-1.4, 0.1, n).astype(np.float32),
               advantages=rng.normal(size=n).astype(np.float32),
               returns=rng.normal(size=n).astype(np.float32))
    b = _rl_batch(SEED + 12)
    vt = {k: b[k] for k in ("obs", "next_obs", "actions", "logp", "rewards",
                            "terminated", "cut")}
    rp = {k: b[k] for k in ("obs", "next_obs", "actions", "rewards",
                            "terminated")}
    sac = dict(rp, actions=b["cont_actions"])
    cql = {k: b[k] for k in ("obs", "action", "reward", "next_obs",
                             "terminated")}
    noise = np.random.default_rng(SEED + 13).normal(
        size=(RL_UPDATES, 2, RL_ROWS, RL_ACT_DIM)).astype(np.float32)
    return {
        "ppo": ("PPOLearner", (RL_OBS, RL_ACTIONS), {}, lambda i: (ppo,)),
        "vtrace": ("VTraceLearner", (RL_OBS, RL_ACTIONS), {},
                   lambda i: (vt,)),
        "appo": ("APPOLearner", (RL_OBS, RL_ACTIONS), {}, lambda i: (vt,)),
        "dqn": ("DQNLearner", (RL_OBS, RL_ACTIONS), {}, lambda i: (rp,)),
        "sac": ("SACLearner", (RL_OBS, RL_ACT_DIM), {},
                lambda i: (sac, noise[i])),
        "bc_discrete": ("BCLearner", (RL_OBS, RL_ACTIONS),
                        dict(discrete=True),
                        lambda i: (b["obs"], b["action"])),
        "bc_continuous": ("BCLearner", (RL_OBS, RL_ACTIONS),
                          dict(discrete=False),
                          lambda i: (b["obs"], b["bc_targets"])),
        "cql": ("CQLLearner", (RL_OBS, RL_ACTIONS), {}, lambda i: (cql,)),
    }


def _rl_run(kind, args, kwargs, update_args, device, weights):
    """RL_UPDATES updates of ``kind`` on ``device`` from ``weights``: the
    metrics of each (a dict, or BC's loss), the final weights and each
    update's seconds (host clock; reading the metrics synchronises)."""
    import ray_tpu_torch.rllib as tr

    lrn = getattr(tr, kind)(*args, device=device, **kwargs)
    lrn.set_weights(weights)
    metrics, secs = [], []
    for i in range(RL_UPDATES):
        t = time.monotonic()
        m = lrn.update(*update_args(i))
        secs.append(time.monotonic() - t)
        metrics.append(m if isinstance(m, dict) else {"loss": m})
    return metrics, lrn.get_weights(), secs


def _rel_errors(got, ref) -> float:
    """The largest ||err|| / ||ref|| over the leaves of two weight nests."""
    import numpy as np

    from ray_tpu_torch.rllib.learner import leaves

    return max(float(np.linalg.norm(g - c) / max(np.linalg.norm(c), 1e-12))
               for g, c in zip(leaves(got), leaves(ref)))


def _nvidia_handles(pid: int) -> list:
    """The NVIDIA device files process ``pid`` holds open or mapped
    (``/dev/nvidia0``, ``/dev/nvidiactl``, ``/dev/nvidia-uvm``...): a
    process with a CUDA context holds them, one that only imported torch
    does not."""
    held = set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                held.add(target)
        with open(f"/proc/{pid}/maps") as f:
            held.update(line.split()[-1] for line in f
                        if " /dev/nvidia" in line)
    except OSError:
        return []
    return sorted(held)


def phase_rl(dev):
    """The learners on the card against themselves on the CPU."""
    import numpy as np
    import torch

    import ray_tpu_torch.rllib as tr

    _check(not torch.backends.cuda.matmul.allow_tf32,
           "rl: TF32 products are on; the learners compute in fp32")
    out, bad = {}, []
    for name, (kind, args, kwargs, update_args) in _rl_cases().items():
        w0 = getattr(tr, kind)(*args, device="cpu", **kwargs).get_weights()
        cpu_m, cpu_w, _ = _rl_run(kind, args, kwargs, update_args, "cpu",
                                  w0)
        gpu_m, gpu_w, secs = _rl_run(kind, args, kwargs, update_args, dev,
                                     w0)
        # each metric's largest error over the updates, relative to its
        # largest value over them (a loss may cross zero); each parameter
        # leaf's ||err|| / ||ref||
        metric_err = {}
        for key in cpu_m[0]:
            ref = np.array([m[key] for m in cpu_m])
            got = np.array([m[key] for m in gpu_m])
            metric_err[key] = float(np.abs(got - ref).max()
                                    / max(np.abs(ref).max(), 1e-12))
        param_err = _rel_errors(gpu_w, cpu_w)
        finite = all(np.isfinite(list(m.values())).all()
                     for m in cpu_m + gpu_m)
        row = dict(learner=kind, kwargs=kwargs,
                   rows=RL_PPO_ROWS if name == "ppo" else RL_ROWS,
                   updates=RL_UPDATES,
                   ms_per_update=1e3 * float(np.mean(secs[1:])),
                   first_update_ms=1e3 * secs[0], metric_rel_err=metric_err,
                   param_rel_err=param_err, finite=finite,
                   last=gpu_m[-1])
        out[name] = row
        print(f"rl {name}: {row['ms_per_update']:.3f} ms an update on the "
              f"card; metrics within {max(metric_err.values()):.2e}, "
              f"parameters within {param_err:.2e} of the CPU", flush=True)
        if not finite or param_err > TOL_RL or max(
                metric_err.values()) > TOL_RL:
            bad.append(name)
    print(json.dumps({"rl": out}), flush=True)
    _check(not bad, f"rl: {bad} beyond {TOL_RL} of the CPU run or not "
           f"finite: {[out[n] for n in bad]}")
    return out


# the runtime phase: the port's own cluster on the card
RUNTIME_CPUS = 4
RUNTIME_FLUSH_S = 0.1      # metrics flush to the control store (default 1 s)
RUNTIME_MODEL = ("llama3_8b", {"param_dtype": "bfloat16"})
RUNTIME_ECFG = dict(max_num_seqs=4, kv_block_size=16, num_kv_blocks=256,
                    max_model_len=1024)  # the serve phase's
RUNTIME_PENDING_WAIT_S = 5.0
RUNTIME_TENSOR_SHAPE = (8192, 16384)   # bf16: 256 MiB
RUNTIME_STORE_BYTES = 1 << 30  # the tensor and _put_stages' copy of it


def _cluster_pids(session_dir: str, owned=()) -> list:
    """Pids of this run's cluster still running: the processes ``init``
    started (``owned``: control store, daemon) and every process whose
    command line or environment names the cluster's session dir (its
    workers). A cluster of another run on the same host is not counted."""
    key = session_dir.encode()
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{d}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if cmd and (int(d) in owned or key in cmd or key in env):
            pids.append(int(d))
    return pids


def _maps_hold(pid: int, *names) -> list:
    """Which of ``names`` (library name parts) process ``pid`` has mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    except OSError:
        return []
    return [n for n in names if n in maps]


def _compute_app_pids() -> list:
    """Pids with a CUDA context, as nvidia-smi lists them ([] when it lists
    none: in a container it may not see the processes)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True)
    return [int(x) for x in smi.stdout.split() if x.strip().isdigit()]


def _tensor_checksums(t) -> list:
    """Two int64 checksums of a bf16 tensor's bits: their sum, and a sum
    weighted by position (a permutation changes it)."""
    import torch

    bits = t.reshape(-1).view(torch.int16).long()
    w = torch.arange(bits.numel(), device=bits.device) % 65521
    return [int(bits.sum()), int((bits * w).sum())]


def _runtime_k1_task(shape, seed):
    """A num_gpus=1 task: one K1 call at the serve shape against its plain
    version, in the worker the lease bound to its device."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    b, h, kvh, s, hd = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, s, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, kvh, s, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, kvh, s, hd), generator=gen, device=dev).bfloat16()
    fa.flash_fwd_launches = 0
    o, lse = fa._flash_fwd_cuda(q, k, v, True)
    torch.cuda.synchronize()
    launches = fa.flash_fwd_launches
    ro, rlse = fa._attention_reference(q, k, v, True)
    err = (o.float() - ro.float()).abs()
    return dict(
        pid=os.getpid(),
        cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
        device_name=torch.cuda.get_device_name(), launches=launches,
        err_o=err.max().item(), err_lse=(lse - rlse).abs().max().item(),
        o_ok=bool((err <= TOL_O + TOL_O_REL * ro.float().abs()).all()),
        finite=bool(torch.isfinite(o).all() and torch.isfinite(lse).all()))


class _EngineHost:
    """The serve phase's model and engine in an actor of the port's runtime:
    ``LLMServer`` builds Llama-3-8B (random bf16 weights from the seed) on
    the device the lease granted, and a ``PagedEngine`` on its weights
    answers streamed requests. Built here, so no weight crosses the object
    store."""

    def __init__(self, model, overrides, ecfg, seed):
        import dataclasses

        import torch

        from ray_tpu_torch.llm import LLMConfig, LLMServer
        from ray_tpu_torch.llm._engine import EngineConfig, PagedEngine

        t0 = time.monotonic()
        kw = {k: getattr(torch, v) if k.endswith("dtype") else v
              for k, v in overrides.items()}
        self.server = LLMServer(LLMConfig(
            model_id=f"{model}-random", model=model,
            model_overrides={**kw, "attention_impl": "flash"}, seed=seed))
        self.xcfg = dataclasses.replace(self.server.cfg, attention_impl="xla")
        self.engine = PagedEngine(self.server.cfg, self.server.params,
                                  EngineConfig(**ecfg))
        torch.cuda.synchronize()
        self.build_s = time.monotonic() - t0

    async def info(self):
        # a coroutine method makes this an async actor (an async generator
        # alone does not), so the streamed requests run concurrently
        import torch

        return dict(pid=os.getpid(), build_s=self.build_s,
                    cuda_visible_devices=os.environ.get(
                        "CUDA_VISIBLE_DEVICES"),
                    device_name=torch.cuda.get_device_name(),
                    n_params=self.server.cfg.num_params(),
                    n_layers=self.server.cfg.n_layers,
                    vocab_size=self.server.cfg.vocab_size,
                    memory_allocated=torch.cuda.memory_allocated())

    async def stream(self, prompt, max_tokens):
        async for tok in self.engine.generate_stream(prompt,
                                                     max_tokens=max_tokens):
            yield tok

    def zero_launches(self):
        from ray_tpu_torch.ops import flash_attention as fa

        fa.flash_fwd_launches = 0
        return self.engine.stats()

    def report(self):
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.util.metrics import snapshot_all

        gauges = {s["name"]: s["value"] for s in snapshot_all()
                  if s["name"].startswith("rt_llm_")
                  and s["type"] == "gauge"}
        return fa.flash_fwd_launches, self.engine.stats(), gauges

    def plain_first_tokens(self, prompts):
        """The plain ("xla") forward's argmax at each prompt's last
        position, and its top-1 margin."""
        import torch

        from ray_tpu_torch.models.llama import forward

        out = []
        with torch.no_grad():
            for p in prompts:
                ref = forward(self.xcfg, self.server.params,
                              torch.tensor([p], device="cuda"))[0, -1]
                top2 = torch.topk(ref.float(), 2).values
                out.append((int(torch.argmax(ref)),
                            float(top2[0] - top2[1])))
        return out

    def complete(self, payload):
        return self.server(payload)


class _VisibleDevices:
    def visible(self):
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")


RUNTIME_HALF_N = 4096      # the half-GPU actors' fp32 product: n x n x n


class _HalfGpu:
    """A num_gpus=0.5 actor: it binds no device (the node's stay visible)
    and runs one seeded fp32 product on the card."""

    def product(self, seed):
        import torch

        g = torch.Generator(device="cuda").manual_seed(seed)
        a = torch.randn(RUNTIME_HALF_N, RUNTIME_HALF_N, device="cuda",
                        generator=g)
        c = a @ a.T
        torch.cuda.synchronize()
        return dict(pid=os.getpid(),
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    device=torch.cuda.get_device_name(0),
                    tf32=torch.backends.cuda.matmul.allow_tf32,
                    sum=float(c.double().sum()),
                    abs_sum=float(c.double().abs().sum()),
                    corner=c[:2, :2].cpu().tolist())


def _runtime_fractional(rt) -> dict:
    """Fractional GPU leases (ROADMAP R5): two num_gpus=0.5 actors at
    once, each running the same product on the card with the same result
    while the GPU reads 0.0 available; a third waits until one of them is
    killed, then runs."""
    Half = rt.remote(num_gpus=0.5)(_HalfGpu)
    t = time.monotonic()
    halves = [Half.remote() for _ in range(2)]
    prods = rt.get([h.product.remote(SEED) for h in halves], timeout=300)
    both_s = time.monotonic() - t
    deadline = time.monotonic() + 10  # the accounting reaches the store
    while (rt.available_resources().get("GPU", 0.0) != 0.0
           and time.monotonic() < deadline):
        time.sleep(0.1)
    avail = rt.available_resources().get("GPU", 0.0)
    third = Half.remote()
    pending = third.product.remote(SEED)
    ready, _ = rt.wait([pending], timeout=RUNTIME_PENDING_WAIT_S)
    rt.kill(halves[0])
    t = time.monotonic()
    late = rt.get(pending, timeout=300)
    out = dict(n=RUNTIME_HALF_N, both_live_s=both_s, available_gpu=avail,
               third_waited=not ready,
               third_started_after_kill_s=time.monotonic() - t,
               actors=prods + [late])
    print(json.dumps({"runtime_fractional": out}), flush=True)
    for h in (halves[1], third):
        rt.kill(h)
    pids = {p["pid"] for p in prods}
    _check(len(pids) == 2, f"runtime: the half-GPU actors share a process: "
           f"{out}")
    _check(avail == 0.0, f"runtime: two half-GPU actors live, but "
           f"{avail} GPU available")
    _check(not ready, "runtime: a third half-GPU actor started while two "
           "held the card")
    ref = prods[0]
    for p in prods[1:] + [late]:
        _check(p["device"] == ref["device"] and not p["tf32"]
               and p["visible"] == os.environ.get("CUDA_VISIBLE_DEVICES")
               and abs(p["sum"] - ref["sum"]) <= 1e-6 * ref["abs_sum"]
               and p["corner"] == ref["corner"],
               f"runtime: half-GPU actors disagree: {p} against {ref}")
    return out


def _runtime_read_tensor(refs):
    """A num_gpus=1 task: get the driver's CUDA tensor (host-staged: the
    store's bytes onto this worker's device) and checksum it."""
    import torch

    import ray_tpu_torch as rt

    torch.empty(1, device="cuda")  # the CUDA context, outside the timing
    torch.cuda.synchronize()
    t0 = time.monotonic()
    t = rt.get(refs[0], timeout=120)
    torch.cuda.synchronize()
    get_s = time.monotonic() - t0
    # its stages: the same get again, the store's pages now mapped in this
    # process; a pageable host-to-device copy alone, from touched memory
    t0 = time.monotonic()
    again = rt.get(refs[0], timeout=120)
    torch.cuda.synchronize()
    get_again_s = time.monotonic() - t0
    del again
    host = torch.ones(t.numel() * t.element_size(), dtype=torch.uint8)
    t0 = time.monotonic()
    host.to("cuda")
    torch.cuda.synchronize()
    h2d_s = time.monotonic() - t0
    return dict(pid=os.getpid(), get_s=get_s, get_again_s=get_again_s,
                h2d_s=h2d_s, device=str(t.device), dtype=str(t.dtype),
                shape=list(t.shape), checksums=_tensor_checksums(t))


def _put_stages(rt, x) -> dict:
    """``put``'s stages for the CUDA tensor ``x`` on this host: serialize
    (its device-to-host copy into fresh pageable memory), the copy of the
    bytes into a new object's untouched store pages, the same copy again
    into those pages once they are mapped (the difference: page faults)."""
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch._private.ids import ObjectID

    store = rt.get_core_worker().store
    t0 = time.monotonic()
    sobj = ser.serialize(x)
    serialize_s = time.monotonic() - t0
    oid = ObjectID.from_random()
    view = store.create(oid, sobj.total_bytes)
    t0 = time.monotonic()
    sobj.write_into(view)
    store_write_s = time.monotonic() - t0
    t0 = time.monotonic()
    sobj.write_into(view)
    store_rewrite_s = time.monotonic() - t0
    view.release()
    store.seal(oid)
    store.delete(oid)
    return dict(serialize_s=serialize_s, store_write_s=store_write_s,
                store_rewrite_s=store_rewrite_s)


def _gauges_through_plane(rt):
    """The rt_llm_* gauges as the control store's scrape reports them:
    {worker: {name: value}}."""
    cw = rt.get_core_worker()
    reply = cw.run_sync(cw.control.call("get_metrics", {}), 30)
    out = {}
    for wid, rec in reply["workers"].items():
        got = {s["name"]: s["value"] for s in rec["metrics"]
               if s.get("name", "").startswith("rt_llm_")
               and s.get("type") == "gauge"}
        if got:
            out[wid.hex() if isinstance(wid, bytes) else str(wid)] = got
    return out


RUNTIME_CAPTURE_S = 1.0    # the dashboard's /api/jax_profile duration
RUNTIME_SCRAPED = ("rt_llm_kv_blocks_in_use", "rt_llm_batch_occupancy")


def _http_get(url, timeout=120.0):
    """(status, body bytes) of a GET; an HTTP error's status and body too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _scrape_gauges(url, names) -> dict:
    """The largest sample of each of ``names`` in the dashboard's
    ``/metrics`` (any labels), and the scrape's seconds under ``_s``."""
    t = time.monotonic()
    status, body = _http_get(f"{url}/metrics", timeout=30)
    out = {"_s": time.monotonic() - t, "_status": status}
    for line in body.decode().splitlines():
        name, _, value = line.partition(" ")
        name = name.split("{", 1)[0]
        if name in names:
            out[name] = max(out.get(name, 0.0), float(value.split()[0]))
    return out


def _runtime_routes(url):
    """Every ``/api`` route the dashboard's page fetches: status, JSON,
    seconds."""
    import re

    t = time.monotonic()
    status, page = _http_get(f"{url}/")
    routes = {"/": dict(status=status, s=time.monotonic() - t)}
    for path in sorted(set(re.findall(r'get\("([^"]+)"\)', page.decode()))):
        t = time.monotonic()
        status, body = _http_get(f"{url}/api/{path}")
        row = dict(status=status, s=time.monotonic() - t, bytes=len(body))
        try:
            json.loads(body)
            row["json"] = True
        except ValueError:
            row["json"] = False
        routes[f"/api/{path}"] = row
    return routes


def _runtime_capture(url, node):
    """One ``/api/jax_profile`` capture on ``node``: its seconds, files,
    and the events of each chrome trace."""
    t = time.monotonic()
    status, body = _http_get(f"{url}/api/jax_profile?node={node}"
                             f"&duration={RUNTIME_CAPTURE_S}")
    capture = dict(status=status, s=time.monotonic() - t)
    if status == 200:
        got = json.loads(body)
        capture.update(node=got["node"], files=got["files"], events=[])
        for path in got["files"]:
            try:
                with open(path) as f:
                    events = json.load(f).get("traceEvents")
                capture["events"].append(
                    len(events) if isinstance(events, list) else None)
            except (OSError, ValueError):
                capture["events"].append(None)
    else:
        capture["error"] = body.decode()[:2000]
    return capture


def phase_runtime(dev, inproc=None):
    """The port's own runtime on the card (see the module docstring);
    ``inproc``: the serve phase's numbers, printed beside the actor's."""
    import threading

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.gpu.accelerator import GpuAcceleratorManager
    from ray_tpu_torch.util.metrics import reset_registry

    out = {}
    torch.cuda.empty_cache()
    # the serve phase's engine, in this process, left its rt_llm_* gauges
    # at 0 in the registry. A gauge ships its value at every flush and the
    # node daemon keeps the last writer of a series, as the JAX package's
    # plane does, so the driver's stale zeros would mask the actor's gauges.
    reset_registry()
    os.environ["RT_GPU_AUTODETECT"] = "1"
    t0 = time.monotonic()
    rt.init(num_cpus=RUNTIME_CPUS,
            system_config={"telemetry_flush_period_s": RUNTIME_FLUSH_S,
                           "object_store_memory_bytes": RUNTIME_STORE_BYTES})
    out["cluster_start_s"] = time.monotonic() - t0
    from ray_tpu_torch._private.worker import global_context

    system_pids = [p.pid for p in global_context().owned_processes]
    session_dir = global_context().session_dir
    try:
        res = rt.cluster_resources()
        labels = rt.nodes()[0]["labels"]
        out.update(resources=res, labels=labels)
        print(f"runtime: cluster up in {out['cluster_start_s']:.2f} s: "
              f"{res}, labels {labels}", flush=True)
        _check(res.get("GPU") == torch.cuda.device_count(),
               f"runtime: GPU resource {res.get('GPU')} != "
               f"{torch.cuda.device_count()} devices")
        _check(labels.get("gpu-name") == torch.cuda.get_device_name(0),
               f"runtime: node labels {labels} lack the card's name")
        t = time.monotonic()
        dash_url = start_dashboard(port=0)
        dash = out["dashboard"] = dict(url=dash_url,
                                       start_s=time.monotonic() - t)
        # a capture on the node runs beside the rest of the phase (a
        # worker's start and torch's import are most of it)
        capture = threading.Thread(target=lambda: dash.update(
            capture=_runtime_capture(dash_url, rt.nodes()[0]["node_id"])),
            daemon=True)
        capture.start()

        # one K1 call in a GPU task
        task = rt.remote(num_gpus=1)(_runtime_k1_task)
        k1 = rt.get(task.remote(K1_MAIN_SHAPE, SEED), timeout=300)
        out["k1_task"] = k1
        print(json.dumps({"runtime_k1_task": k1}), flush=True)
        _check(k1["launches"] == 1 and k1["finite"] and k1["o_ok"]
               and k1["err_lse"] <= TOL_LSE,
               f"runtime: K1 in a GPU task: {k1}")
        _check(k1["device_name"] == torch.cuda.get_device_name(0),
               f"runtime: the task's device is {k1['device_name']}")

        # the serving path in a GPU actor
        model, overrides = RUNTIME_MODEL
        Host = rt.remote(num_gpus=1)(_EngineHost)
        t = time.monotonic()
        host = Host.remote(model, overrides, RUNTIME_ECFG, SEED)
        info = rt.get(host.info.remote(), timeout=600)
        info["actor_start_s"] = time.monotonic() - t
        out["actor"] = info
        print(json.dumps({"runtime_actor": info}), flush=True)
        rng = np.random.RandomState(SEED + 1)   # the serve phase's prompts
        vocab = info["vocab_size"]
        prompts = [rng.randint(0, vocab, size=n).tolist()
                   for n in SERVE_PROMPTS]
        warm = rng.randint(0, vocab, size=100).tolist()
        for ref in host.stream.options(num_returns="streaming").remote(
                warm, 4):
            rt.get(ref, timeout=120)
        base = rt.get(host.zero_launches.remote(), timeout=60)
        submit, stamps, toks = {}, {}, {}
        peak, scraped, scrape_s = {}, {}, []
        stop, first = threading.Event(), threading.Event()

        def poll():
            while not stop.is_set():
                for g in _gauges_through_plane(rt).values():
                    for k, v in g.items():
                        peak[k] = max(peak.get(k, 0.0), v)
                got = _scrape_gauges(dash_url, RUNTIME_SCRAPED)
                scrape_s.append(got.pop("_s"))
                if got.pop("_status") == 200:
                    for k, v in got.items():
                        scraped[k] = max(scraped.get(k, 0.0), v)
                stop.wait(RUNTIME_FLUSH_S / 2)

        def one(i):
            submit[i] = time.monotonic()
            gen = host.stream.options(num_returns="streaming").remote(
                prompts[i], SERVE_MAX_TOKENS)
            ts, got = [], []
            for ref in gen:
                got.append(rt.get(ref, timeout=120))
                ts.append(time.monotonic())
                first.set()
            toks[i], stamps[i] = got, ts

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        t_start = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        first.wait(600)  # the last request arrives mid-decode
        threads.append(threading.Thread(target=one, args=(3,)))
        threads[-1].start()
        for th in threads:
            th.join(600)
        wall = time.monotonic() - t_start
        time.sleep(3 * RUNTIME_FLUSH_S)  # the last flush of the gauges
        stop.set()
        poller.join(10)
        launches, st, local_gauges = rt.get(host.report.remote(), timeout=60)
        plane = _gauges_through_plane(rt)
        ref_first = rt.get(host.plain_first_tokens.remote(prompts),
                           timeout=300)
        done = rt.get(host.complete.remote(
            {"prompt": ["The H100 is"], "max_tokens": 4}), timeout=300)
        n_tokens = sum(len(v) for v in toks.values())
        ttft = {SERVE_PROMPTS[i]: stamps[i][0] - submit[i] for i in stamps
                if stamps[i]}
        serve = dict(
            tokens_out=n_tokens, wall_s=wall, tokens_per_s=n_tokens / wall,
            ttft_s=ttft, ttft_p50_s=sorted(ttft.values())[len(ttft) // 2],
            k1_launches=launches,
            mid_decode_admissions=(st["mid_decode_admissions"]
                                   - base["mid_decode_admissions"]),
            first_token_top1_margins=[m for _, m in ref_first],
            gauges_peak_through_plane=peak, gauges_final_through_plane=plane,
            gauges_final_in_actor=local_gauges,
            llm_server_completion_tokens=done["usage"]["completion_tokens"])
        out["serve"] = serve
        print(json.dumps({"runtime_serve": serve}), flush=True)
        if inproc is not None:
            print(f"runtime: through the actor TTFT p50 "
                  f"{serve['ttft_p50_s']:.4f} s, {serve['tokens_per_s']:.1f} "
                  f"tokens/s; in process TTFT p50 "
                  f"{inproc['ttft_p50_s']:.4f} s, "
                  f"{inproc['tokens_per_s']:.1f} tokens/s", flush=True)
        _check(all(len(toks.get(i, [])) == SERVE_MAX_TOKENS
                   for i in range(len(prompts))),
               f"runtime: not every request got {SERVE_MAX_TOKENS} tokens")
        for i, (want, margin) in enumerate(ref_first):
            _check(toks[i][0] == want,
                   f"runtime: request {i}: first token {toks[i][0]} != the "
                   f"plain forward's argmax {want} (margin {margin:.4f})")
        _check(launches == len(prompts) * info["n_layers"],
               f"runtime: the actor's engine launched K1 {launches} times")
        _check(serve["mid_decode_admissions"] >= 1,
               "runtime: no mid-decode admission")
        want_final = {"rt_llm_batch_occupancy": 0.0,
                      "rt_llm_kv_blocks_in_use": 0}
        _check(local_gauges == want_final
               and want_final in [dict(g) for g in plane.values()],
               f"runtime: gauges in the actor {local_gauges}, through the "
               f"plane {plane}")
        _check(peak.get("rt_llm_batch_occupancy", 0) > 0
               and peak.get("rt_llm_kv_blocks_in_use", 0) > 0,
               f"runtime: the plane never showed a busy engine: {peak}")

        # the dashboard on this cluster: its scrape while the engine served,
        # the page's routes
        dash.update(scraped_peak=scraped, scrapes=len(scrape_s),
                    scrape_s_p50=sorted(scrape_s)[len(scrape_s) // 2],
                    scrape_s_max=max(scrape_s),
                    routes=_runtime_routes(dash_url))
        print(f"runtime: dashboard up {dash['start_s']:.2f} s; /metrics "
              f"{dash['scrapes']} scrapes while serving, p50 "
              f"{dash['scrape_s_p50']:.4f} s, peak {scraped}; routes "
              + ", ".join(f"{p} {r['s']:.4f} s"
                          for p, r in dash["routes"].items()), flush=True)
        _check(all(scraped.get(k, 0) > 0 for k in RUNTIME_SCRAPED),
               f"runtime: the dashboard's /metrics never showed a busy "
               f"engine: {scraped}")
        _check(all(r["status"] == 200 and r.get("json", True)
                   for r in dash["routes"].values()),
               f"runtime: dashboard routes {dash['routes']}")

        # no CUDA context, and no torch, in the daemon or the control store:
        # neither is in nvidia-smi's list (in a container it may list no
        # real pid) nor maps libcuda or libtorch, which the actor does
        apps = _compute_app_pids()
        held = {p: _maps_hold(p, "libcuda", "libtorch") for p in system_pids}
        actor_maps = _maps_hold(info["pid"], "libcuda", "libtorch")
        out["system_processes"] = dict(
            pids=system_pids, compute_apps=apps, mapped=held,
            actor_listed=info["pid"] in apps, actor_mapped=actor_maps)
        print(json.dumps({"runtime_system_processes":
                          out["system_processes"]}), flush=True)
        _check(actor_maps == ["libcuda", "libtorch"],
               f"runtime: the actor maps {actor_maps}: the check cannot see "
               f"a CUDA context")
        _check(not set(system_pids) & set(apps) and not any(held.values()),
               f"runtime: a system process holds CUDA or torch: "
               f"{out['system_processes']}")

        # GPU lease accounting: a second 1-GPU actor waits for the card
        Vis = rt.remote(num_gpus=1)(_VisibleDevices)
        second = Vis.remote()
        pending = second.visible.remote()
        ready, _ = rt.wait([pending], timeout=RUNTIME_PENDING_WAIT_S)
        _check(not ready, "runtime: a second 1-GPU actor started while the "
               "engine actor held the card")
        rt.kill(host)
        t = time.monotonic()
        pid2, visible2 = rt.get(pending, timeout=120)
        gpus = GpuAcceleratorManager.detect(allow_cuda_probe=False)
        want_env = dict(os.environ)
        GpuAcceleratorManager.set_visible_devices_env(
            want_env, gpus.device_ids[:1], gpus.count)
        out["lease"] = dict(pending_after_s=RUNTIME_PENDING_WAIT_S,
                            started_after_kill_s=time.monotonic() - t,
                            cuda_visible_devices=visible2)
        print(json.dumps({"runtime_lease": out["lease"]}), flush=True)
        _check(visible2 == want_env.get("CUDA_VISIBLE_DEVICES"),
               f"runtime: the second actor sees CUDA_VISIBLE_DEVICES "
               f"{visible2!r}")
        rt.kill(second)
        out["fractional"] = _runtime_fractional(rt)

        # a CUDA tensor through the object store, host-staged
        x = torch.randn(RUNTIME_TENSOR_SHAPE, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED)).bfloat16()
        want = _tensor_checksums(x)
        nbytes = x.numel() * x.element_size()
        torch.cuda.synchronize()
        t = time.monotonic()
        x.cpu()  # the device-to-host copy alone, into fresh host memory
        d2h_s = time.monotonic() - t
        t = time.monotonic()
        ref = rt.put(x)
        put_s = time.monotonic() - t
        reader = rt.remote(num_gpus=1)(_runtime_read_tensor)
        got = rt.get(reader.remote([ref]), timeout=300)
        obj = dict(bytes=nbytes, d2h_s=d2h_s, put_s=put_s,
                   put_gbps=nbytes / put_s / 1e9,
                   get_s=got["get_s"], get_gbps=nbytes / got["get_s"] / 1e9,
                   get_again_s=got["get_again_s"], h2d_s=got["h2d_s"],
                   **_put_stages(rt, x),
                   device=got["device"], checksums=got["checksums"],
                   want=want)
        out["object"] = obj
        print(json.dumps({"runtime_object": obj}), flush=True)
        _check(got["checksums"] == want and got["device"].startswith("cuda")
               and got["dtype"] == "torch.bfloat16"
               and got["shape"] == list(RUNTIME_TENSOR_SHAPE),
               f"runtime: the CUDA tensor came back different: {got}")
        del x, ref

        capture.join(300)
        t = time.monotonic()
        stop_dashboard()
        dash["stop_s"] = time.monotonic() - t
        print(json.dumps({"runtime_dashboard": dash}), flush=True)
        cap = dash.get("capture") or {"status": None, "s": float("nan")}
        print(f"runtime: /api/jax_profile {cap['s']:.2f} s "
              f"({RUNTIME_CAPTURE_S} s capture, beside the rest of the "
              f"phase), {len(cap.get('files', []))} trace(s)", flush=True)
        _check(cap["status"] == 200 and cap.get("files")
               and all(n is not None for n in cap["events"]),
               f"runtime: /api/jax_profile {cap}")
    finally:
        rt.shutdown()
        os.environ.pop("RT_GPU_AUTODETECT", None)
    deadline = time.monotonic() + 30
    while (_cluster_pids(session_dir, system_pids)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    left = _cluster_pids(session_dir, system_pids)
    out["left_after_shutdown"] = left
    _check(not left, f"runtime: processes left after shutdown: {left}")
    print(f"runtime: shut down, no process of the cluster left", flush=True)
    return out


TRAINER_CPUS = 4
# the flagship at full width and 4 of its 16 layers (the depth cut keeps
# the phase inside chip_smoke's time budget; the train phase runs all 16):
# K1/K2/K3 8/4/4 a step
TRAINER_LAYERS = 4
TRAINER_CFG = dict(TRAIN_CFG, n_layers=TRAINER_LAYERS)
TRAINER_STEPS = 9
TRAINER_CKPT_STEPS = (2, 5, 8)
TRAINER_KILL_AFTER = 4     # the first attempt exits after this step's report
TOL_TRAINER_LOSS = 1e-2    # absolute, against the same steps in process
TOL_TRAINER_RESUME = 1e-5  # a resumed step against the killed run's


def _trainer_fn(config):
    """The trainer phase's train fn, in a num_gpus=1 train worker: the
    flagship from the seed, restored from the run's latest checkpoint,
    ``make_train_step`` steps on the train batch, a report after each
    (with the train state at ``ckpt_steps``); the first attempt exits
    after ``kill_after``'s report, once the step-2 checkpoint is final and
    the controller holds every report."""
    import os
    import time

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.ops import flash_attention as fa

    t_fn = time.time()
    restarted = os.path.exists(config["marker"])
    dev = train.setup_torch_distributed()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t_cuda = time.time()
    ctx = train.get_context()
    cfg = LlamaConfig(**config["cfg"], attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=config["lr"], remat=config["remat"],
        loss_chunk=0, device=dev)
    params, opt = shard_state(init_state(config["seed"]))
    start, restore_s = 1, None
    ckpt = ctx.get_checkpoint()
    if ckpt is not None:
        t = time.time()
        tree = ckpt.load_state(train.train_state_tree(params, opt))
        train.load_train_state(tree, params, opt)
        torch.cuda.synchronize()
        restore_s = time.time() - t
        start = ckpt.step + 1
    tokens = torch.from_numpy(config["tokens"]).to(data_dev)
    prev_report = None  # (step, seconds its report blocked)
    for step in range(start, config["steps"] + 1):
        fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
        fa.flash_bwd_dkv_launches = 0
        torch.cuda.synchronize()
        t = time.time()
        (params, opt), loss = train_step((params, opt), tokens)
        loss = float(loss)
        step_s = time.time() - t
        metrics = dict(
            step=step, loss=loss, step_s=step_s, restarted=restarted,
            pid=os.getpid(), device=str(dev),
            device_name=torch.cuda.get_device_name(dev),
            visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
            launches=dict(k1=fa.flash_fwd_launches,
                          k2=fa.flash_bwd_dq_launches,
                          k3=fa.flash_bwd_dkv_launches),
            t_fn=t_fn, t_cuda=t_cuda, t_step_end=time.time(),
            restore_s=restore_s if step == start else None,
            prev_report=prev_report)
        t = time.time()
        if step in config["ckpt_steps"]:
            train.report(metrics, checkpoint_state=train.train_state_tree(
                params, opt))
        else:
            train.report(metrics)
        prev_report = (step, time.time() - t)
        if step == config["kill_after"] and not restarted:
            final = os.path.join(config["run_dir"], "checkpoint_%09d"
                                 % config["ckpt_steps"][0])
            deadline = time.time() + 300
            while time.time() < deadline and not (
                    os.path.isdir(final) and ctx.report_queue.empty()):
                time.sleep(0.05)
            with open(config["marker"], "w") as f:
                f.write(repr(time.time()))
            os._exit(1)
    # the last report's blocking time rides a report of its own
    train.report({"step": config["steps"], "final": True,
                  "prev_report": prev_report})


def _trainer_reference(dev):
    """TRAINER_STEPS in-process steps of the worker's run (TRAINER_CFG, the
    train phase's seed, batch, lr and remat): the losses and the median
    step ms after the first."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step

    cfg = LlamaConfig(**TRAINER_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _train_tokens(data_dev)
    losses, step_s = [], []
    for _ in range(TRAINER_STEPS):
        torch.cuda.synchronize()
        t = time.monotonic()
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
        step_s.append(time.monotonic() - t)
    del state
    torch.cuda.empty_cache()
    return losses, 1e3 * sorted(step_s[1:])[len(step_s[1:]) // 2]


def phase_trainer(dev):
    """``TorchTrainer`` on the port's cluster (see the module docstring):
    the flagship at TRAINER_LAYERS layers trained in a num_gpus=1 train
    worker across a kill of the worker, held to the same steps in
    process."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.train import (Checkpoint, CheckpointConfig,
                                     FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer,
                                     load_train_state, train_state_tree)

    t_phase = time.monotonic()
    train_losses, inproc_step_ms = _trainer_reference(dev)
    torch.cuda.empty_cache()
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    os.environ["RT_GPU_AUTODETECT"] = "1"
    t0 = time.monotonic()
    rt.init(num_cpus=TRAINER_CPUS)
    out["cluster_start_s"] = time.monotonic() - t0
    from ray_tpu_torch._private.worker import global_context

    system_pids = [p.pid for p in global_context().owned_processes]
    session_dir = global_context().session_dir
    try:
        config = dict(
            cfg=TRAINER_CFG, lr=TRAIN_LR, remat=TRAIN_REMAT, seed=SEED,
            tokens=_train_tokens_np(), steps=TRAINER_STEPS,
            ckpt_steps=TRAINER_CKPT_STEPS, kill_after=TRAINER_KILL_AFTER,
            marker=os.path.join(tmp, "killed"),
            run_dir=os.path.join(tmp, "trainer"))
        t_fit = time.time()
        result = TorchTrainer(
            _trainer_fn, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                name="trainer", storage_path=tmp,
                failure_config=FailureConfig(max_failures=1),
                checkpoint_config=CheckpointConfig(num_to_keep=2)),
        ).fit()
        fit_s = time.time() - t_fit
        with open(config["marker"]) as f:
            t_kill = float(f.read())
        hist = [m for m in result.metrics_history if "loss" in m]
        first = [m for m in hist if not m["restarted"]]
        second = [m for m in hist if m["restarted"]]
        final = [m for m in result.metrics_history if m.get("final")]
        launches = {k: sum(m["launches"][k] for m in hist)
                    for k in ("k1", "k2", "k3")}
        kept = sorted(d for d in os.listdir(config["run_dir"])
                      if d.startswith("checkpoint_"))

        # the kept step-8 checkpoint, read in the driver, gives the
        # worker's step-9 loss
        cfg = LlamaConfig(**TRAINER_CFG, attention_impl="flash")
        init_state, shard_state, train_step, data_dev = make_train_step(
            cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
            device=dev)
        params, opt = shard_state(init_state(SEED))
        t = time.monotonic()
        tree = Checkpoint(result.checkpoint.path).load_state(
            train_state_tree(params, opt))
        load_train_state(tree, params, opt)
        torch.cuda.synchronize()
        driver_load_s = time.monotonic() - t
        count = int(tree[1][0][0])
        _, loss = train_step((params, opt), _train_tokens(data_dev))
        driver_loss = float(loss)
        del params, opt, tree
        torch.cuda.empty_cache()

        def steady(ms):  # each attempt's first step carries its warm-up
            return [m["step_s"] for m in ms[1:]]

        step_s = sorted(steady(first) + steady(second))
        worker_loss = {m["step"]: m["loss"] for m in second}
        out.update(
            config=dict(TRAINER_CFG, attention_impl="flash",
                        remat=TRAIN_REMAT, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        lr=TRAIN_LR, steps=TRAINER_STEPS,
                        ckpt_steps=TRAINER_CKPT_STEPS,
                        kill_after=TRAINER_KILL_AFTER),
            fit_s=fit_s,
            worker_start_s=first[0]["t_cuda"] - t_fit,
            worker_cuda_s=first[0]["t_cuda"] - first[0]["t_fn"],
            kill_to_resumed_step_s=second[0]["t_step_end"] - t_kill,
            kill_to_resumed_cuda_s=second[0]["t_cuda"] - t_kill,
            restore_s=second[0]["restore_s"],
            steps_first=[m["step"] for m in first],
            steps_second=[m["step"] for m in second],
            losses_first=[m["loss"] for m in first],
            losses_second=[m["loss"] for m in second],
            in_process_losses=train_losses[:TRAINER_STEPS],
            step_ms_median=1e3 * step_s[len(step_s) // 2],
            step_ms=[1e3 * x for x in step_s],
            report_s={m["prev_report"][0]: m["prev_report"][1]
                      for m in hist + final if m["prev_report"]},
            in_process_step_ms=inproc_step_ms,
            launches=launches,
            launches_per_step=[m["launches"] for m in hist],
            devices=sorted({(m["device"], m["device_name"], m["visible"])
                            for m in hist}),
            kept=kept, driver_load_s=driver_load_s, driver_count=count,
            driver_loss=driver_loss, worker_step9_loss=worker_loss.get(
                TRAINER_STEPS))
        print(json.dumps({"trainer": out}), flush=True)
        print(f"trainer: cluster up {out['cluster_start_s']:.2f} s; worker "
              f"up {out['worker_start_s']:.2f} s after fit() (its CUDA "
              f"context {out['worker_cuda_s']:.2f} s of it); step "
              f"{out['step_ms_median']:.1f} ms in the worker against "
              f"{out['in_process_step_ms']:.1f} ms in process (both at "
              f"{TRAINER_LAYERS} layers); kill to "
              f"the resumed worker's first step "
              f"{out['kill_to_resumed_step_s']:.2f} s; report blocks "
              f"{out['report_s']} s", flush=True)
    finally:
        rt.shutdown()
        os.environ.pop("RT_GPU_AUTODETECT", None)
        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.monotonic() + 30
    while (_cluster_pids(session_dir, system_pids)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    left = _cluster_pids(session_dir, system_pids)
    out["left_after_shutdown"] = left
    out["phase_s"] = time.monotonic() - t_phase
    print(f"trainer: phase {out['phase_s']:.1f} s", flush=True)

    L = TRAINER_CFG["n_layers"]
    _check(out["steps_first"] == list(range(1, TRAINER_KILL_AFTER + 1))
           and out["steps_second"] == list(
               range(TRAINER_CKPT_STEPS[0] + 1, TRAINER_STEPS + 1)),
           f"trainer: steps {out['steps_first']} then "
           f"{out['steps_second']}: the restart did not resume from the "
           f"step-{TRAINER_CKPT_STEPS[0]} checkpoint")
    for m in hist:
        _check(np.isfinite(m["loss"]) and abs(
            m["loss"] - train_losses[m["step"] - 1]) <= TOL_TRAINER_LOSS,
            f"trainer: step {m['step']} loss {m['loss']} against "
            f"{train_losses[m['step'] - 1]} in process")
        _check(m["launches"] == dict(k1=2 * L, k2=L, k3=L),
               f"trainer: step {m['step']} launched {m['launches']}")
    for a in first:
        if a["step"] in worker_loss:
            _check(abs(a["loss"] - worker_loss[a["step"]])
                   <= TOL_TRAINER_RESUME,
                   f"trainer: resumed step {a['step']} loss "
                   f"{worker_loss[a['step']]} against the killed run's "
                   f"{a['loss']}")
    _check(all(d[0] == "cuda:0" and d[1] == torch.cuda.get_device_name(0)
               for d in out["devices"]),
           f"trainer: the worker ran on {out['devices']}")
    # retention as the JAX package's CheckpointManager: with no score
    # attribute, the earliest num_to_keep - 1 and the latest
    _check(len(out["kept"]) == 2 and out["kept"][-1] == "checkpoint_%09d"
           % TRAINER_CKPT_STEPS[-1], f"trainer: kept {out['kept']}")
    _check(count == TRAINER_CKPT_STEPS[-1]
           and abs(driver_loss - out["worker_step9_loss"])
           <= TOL_TRAINER_RESUME,
           f"trainer: the driver's restore of the kept checkpoint (count "
           f"{count}) steps to {driver_loss}, the worker to "
           f"{out['worker_step9_loss']}")
    _check(not left, f"trainer: processes left after shutdown: {left}")
    return out


STAGES = 2                 # S: stage actors
STAGES_MICRO = 4           # M: microbatches of TRAIN_BATCH / M sequences
STAGES_STEPS = 3
STAGES_CPUS = 4
# a channel slot holds one stage's activation (2 x 2048 x 1024 bf16 = 8 MiB)
# plus its pickle header: CompiledActorPipeline's default 8 MiB is too small
STAGES_SLOT = 9 << 20
STAGES_STORE_BYTES = 3 << 30   # 2 x the pipeline's rings, and the eager
TOL_STAGES_LOSS = 1e-2     # absolute, against make_train_step in process
TOL_STAGES_EAGER_COMPILED = 1e-3


def phase_stages(dev):
    """The flagship trained by pipeline-stage actors (see the module
    docstring): ``ActorPipeline``, then ``CompiledActorPipeline``."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.train.pipeline_actors import (ActorPipeline,
                                                     CompiledActorPipeline)

    t_phase = time.monotonic()
    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    # the in-process reference: no remat (a stage's backward recomputes
    # its forward under autograd, unchecked)
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=False, loss_chunk=0, device=dev)
    state = shard_state(init_state(SEED))
    tokens = _train_tokens_np()
    toks = torch.from_numpy(tokens).to(data_dev)
    ref = []
    for _ in range(STAGES_STEPS):
        state, loss = train_step(state, toks)
        ref.append(float(loss))
    del state, toks
    torch.cuda.empty_cache()

    S, M = STAGES, STAGES_MICRO
    per_stage = cfg.n_layers // S
    each_gpu = torch.cuda.device_count() >= S
    stage_options = [{"num_gpus": 1}] * S if each_gpu else None
    placement = ("a num_gpus=1 lease a stage" if each_gpu else
                 f"{S} stages on the one card without leases, a process "
                 f"and a CUDA context each")
    out = dict(config=dict(TRAIN_CFG, attention_impl="flash", remat=False,
                           batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                           stages=S, microbatches=M, steps=STAGES_STEPS),
               placement=placement, slot_size=STAGES_SLOT,
               in_process_losses=ref)
    print(f"stages: {placement}; channel slot_size {STAGES_SLOT} bytes",
          flush=True)
    os.environ["RT_GPU_AUTODETECT"] = "1"
    rt.init(num_cpus=STAGES_CPUS,
            system_config={"object_store_memory_bytes": STAGES_STORE_BYTES})
    from ray_tpu_torch._private.worker import global_context

    system_pids = [p.pid for p in global_context().owned_processes]
    session_dir = global_context().session_dir
    try:
        for name, make in (
                ("eager", lambda: ActorPipeline(
                    cfg, S, M, learning_rate=TRAIN_LR, seed=SEED,
                    stage_options=stage_options)),
                ("compiled", lambda: CompiledActorPipeline(
                    cfg, S, M, learning_rate=TRAIN_LR, seed=SEED,
                    slot_size=STAGES_SLOT, stage_options=stage_options))):
            t = time.monotonic()
            pipe = make()
            try:
                losses, step_s = [], []
                for _ in range(STAGES_STEPS):
                    t1 = time.monotonic()
                    losses.append(pipe.train_step(tokens, timeout=600))
                    step_s.append(time.monotonic() - t1)
                if name == "compiled":
                    pipe.teardown()
                stats = pipe.stage_stats()
            finally:
                pipe.shutdown()
            out[name] = dict(losses=losses, step_s=step_s,
                             wall_s=time.monotonic() - t, stage_stats=stats)
            print(json.dumps({f"stages_{name}": out[name]}), flush=True)
    finally:
        rt.shutdown()
        os.environ.pop("RT_GPU_AUTODETECT", None)
    deadline = time.monotonic() + 30
    while (_cluster_pids(session_dir, system_pids)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    left = _cluster_pids(session_dir, system_pids)
    out["left_after_shutdown"] = left
    out["launches"] = {k: sum(st[k] for name in ("eager", "compiled")
                              for stage in out[name]["stage_stats"]
                              for st in stage) for k in ("k1", "k2", "k3")}
    mb, seq = TRAIN_BATCH // M, TRAIN_SEQ
    want_bytes = 2 * (S - 1) * M * mb * seq * cfg.dim * 2
    out["handoff_bytes_per_step"] = want_bytes
    out["phase_s"] = time.monotonic() - t_phase
    print(f"stages: step {np.median(out['eager']['step_s']):.3f} s eager, "
          f"{np.median(out['compiled']['step_s']):.3f} s compiled; "
          f"slot_size {STAGES_SLOT}; phase {out['phase_s']:.1f} s",
          flush=True)
    want = dict(k1=2 * M * per_stage, k2=M * per_stage, k3=M * per_stage)
    for name in ("eager", "compiled"):
        got = out[name]
        _check(all(np.isfinite(got["losses"])) and max(
            abs(a - b) for a, b in zip(got["losses"], ref))
            <= TOL_STAGES_LOSS,
            f"stages: {name} losses {got['losses']} against {ref} in "
            f"process")
        for sid, stage in enumerate(got["stage_stats"]):
            _check(len(stage) == STAGES_STEPS and all(
                {k: st[k] for k in want} == want for st in stage),
                f"stages: {name} stage {sid} launched {stage}, want {want} "
                f"a step")
        for i in range(STAGES_STEPS):
            moved = sum(stage[i]["handoff_bytes"]
                        for stage in got["stage_stats"])
            _check(moved == want_bytes,
                   f"stages: {name} step {i} handed on {moved} bytes, want "
                   f"{want_bytes}")
    _check(max(abs(a - b) for a, b in zip(out["eager"]["losses"],
                                          out["compiled"]["losses"]))
           <= TOL_STAGES_EAGER_COMPILED,
           f"stages: eager {out['eager']['losses']} against compiled "
           f"{out['compiled']['losses']}")
    _check(not left, f"stages: processes left after shutdown: {left}")
    return out


# the apps phase: the port's serve library and LLM apps on the card
APPS_CPUS = 8
# Llama-3-8B at full width and 8 of its 32 layers in every process of the
# apps (the depth cut keeps the phase inside chip_smoke's time budget; the
# serve and runtime phases run all 32), held to in-process references at
# the same depth: K1 8 a prompt
APPS_LAYERS = 8
APPS_MODEL = (RUNTIME_MODEL[0], dict(RUNTIME_MODEL[1], n_layers=APPS_LAYERS))
APPS_STORE_BYTES = 1 << 30     # the prefills' KV until the ingress drops it
APPS_INIT_TIMEOUT_S = 300.0    # a replica's construction gate: an 8B build
APPS_LEASE_WAIT_S = 15.0


def _apps_prompts(seed):
    """Strings whose byte tokens (BOS and one per byte) have the serve
    phase's lengths."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    return ["".join(rng.choice(letters, size=n - 1)) for n in SERVE_PROMPTS]


def _post(url, payload):
    """A JSON POST through urllib: the open response."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=600)


def _post_json(url, payload):
    with _post(url, payload) as r:
        return json.loads(r.read())


def _sse(url, payload):
    """An SSE request: (its data events, seconds to the first event)."""
    t0 = time.monotonic()
    first, events = None, []
    with _post(url, payload) as r:
        _check(r.headers.get("Content-Type", "").startswith(
            "text/event-stream"), f"apps: not an event stream: {r.headers}")
        for raw in r:
            line = raw.decode().rstrip("\r\n")
            if line.startswith("data: "):
                if first is None:
                    first = time.monotonic() - t0
                events.append(line[len("data: "):])
    return events, first


def _apps_config(fields):
    """Unpickles an ``LLMConfig`` of the apps phase: first installs
    chip_smoke's counters in this process (``_apps_install``)."""
    _apps_install()
    from ray_tpu_torch.llm import LLMConfig

    return LLMConfig(**fields)


def _apps_config_reduce(self):
    import dataclasses

    return (_apps_config, ({f.name: getattr(self, f.name)
                            for f in dataclasses.fields(self)},))


def _apps_record():
    """This process's record of what the apps phase reads (made by
    ``_apps_install``). Looked up at each call: the classes an ingress
    hands its actors travel by value, with these functions in them."""
    import ray_tpu_torch.llm as llm

    return llm._chip_smoke_record


def _apps_report(device, zero):
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    n = fa.flash_fwd_launches
    if zero:
        fa.flash_fwd_launches = 0
    return dict(_apps_record(), pid=os.getpid(), k1=n, device=str(device),
                device_name=torch.cuda.get_device_name(),
                dp_rank=os.environ.get("RT_DP_RANK"))


def _apps_install():
    """chip_smoke's counters in a process of the apps phase. Every process
    the apps give an ``LLMConfig`` (a replica, a prefill worker, an
    engine) unpickles it through ``_apps_config``, which calls this first,
    so the port's own classes, deployed by its own builders, run there
    with what this script reads added: an ``apps_report`` method on each
    (K1's launch count in the process, the KV bytes its prefills handed
    on, when each engine stream started and what it produced, when its
    model was built, its device) and nothing changed in what they
    compute. The config's pickling is hooked here too, so the actors an
    ingress makes get the counters."""
    import ray_tpu_torch.llm as llm
    from ray_tpu_torch.llm import _engine
    from ray_tpu_torch.llm import serving_patterns as sp

    if hasattr(llm, "_chip_smoke_record"):
        return
    llm._chip_smoke_record = {"built_at": None, "streams": [],
                              "handoffs": []}
    llm.LLMConfig.__reduce__ = _apps_config_reduce

    def timed_init(cls):
        init = cls.__init__

        def __init__(self, *a, **kw):
            import torch

            init(self, *a, **kw)
            torch.cuda.synchronize()
            _apps_record()["built_at"] = time.monotonic()

        cls.__init__ = __init__

    engine_stream = _engine.PagedEngine.generate_stream

    async def counted_engine_stream(self, prompt_ids, **opts):
        r = dict(prompt=list(prompt_ids), tokens=[],
                 prefilled=opts.get("prefilled") is not None,
                 start=time.monotonic())
        _apps_record()["streams"].append(r)
        async for t in engine_stream(self, prompt_ids, **opts):
            r["tokens"].append(int(t))
            yield t

    _engine.PagedEngine.generate_stream = counted_engine_stream
    worker = sp.PrefillWorker._cls
    prefill = worker.prefill

    def counted_prefill(self, prompt_ids):
        t0 = time.monotonic()
        out = prefill(self, prompt_ids)
        _apps_record()["handoffs"].append(dict(
            tokens=len(prompt_ids), start=t0, end=time.monotonic(),
            bytes=sum(out[k].numel() * out[k].element_size()
                      for k in ("k", "v")),
            k_shape=list(out["k"].shape), k_dtype=str(out["k"].dtype),
            k_device=str(out["k"].device)))
        return out

    worker.prefill = counted_prefill
    for cls in (llm.LLMServer, worker, llm.LLMEngine._cls):
        timed_init(cls)
    llm.LLMServer.apps_report = lambda self, zero=False: _apps_report(
        self.params["tok_emb"].device, zero)
    worker.apps_report = lambda self, zero=False: _apps_report(
        self.device, zero)

    async def engine_report(self, zero=False):
        return _apps_report(self.engine.device, zero)

    llm.LLMEngine._cls.apps_report = engine_report

    async def gather(actors, zero):
        return [await a.apps_report.remote(zero) for a in actors]

    async def pd_report(self, zero=False):
        return dict(prefill=await gather(self.prefill_workers, zero),
                    decode=await gather(self.decoders, zero))

    async def dp_report(self, zero=False):
        return dict(engines=await gather(self.engines, zero))

    sp.PrefillDecodeIngress.apps_report = pd_report
    sp.DPEngineGroup.apps_report = dp_report


class _LeaseProbe:
    """A 1-GPU replica of chip_smoke's own: the devices its lease left it."""

    def __call__(self, _x=None):
        import torch

        return dict(pid=os.getpid(),
                    cuda_visible_devices=os.environ.get(
                        "CUDA_VISIBLE_DEVICES"),
                    device_count=torch.cuda.device_count())


def _ttft_p50(samples):
    return sorted(samples)[len(samples) // 2]


def _running(pid: int) -> bool:
    """Whether ``pid`` is a live process (a zombie, which holds no memory
    and has no command line, is not)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return bool(f.read())
    except OSError:
        return False


def _app_actors():
    """The ids of every actor of the cluster."""
    from ray_tpu_torch.util.state import list_actors

    return {a["actor_id"] for a in list_actors()}


def _end_app(name, before, pids, what, timeout=60.0):
    """``serve.delete`` an app, then kill the unnamed actors its ingress
    made (those not in ``before``): as in the JAX package, they outlive
    the replica that made them. Gate: the processes ``pids`` have exited,
    so their models no longer hold the card."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.util.state import list_actors

    serve.delete(name)
    cw = rt.get_core_worker()
    for a in list_actors():
        if (a["actor_id"] not in before and not a["name"]
                and a["state"] != "DEAD"):
            cw.run_sync(cw.kill_actor(bytes.fromhex(a["actor_id"]), True),
                        30)
    deadline = time.monotonic() + timeout
    while any(map(_running, pids)) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = [p for p in pids if _running(p)]
    _check(not left, f"apps: {what} still running after serve.delete: "
           f"{left}")


def phase_apps(report):
    """The port's serve library and LLM apps on the card (see the module
    docstring); ``report``: the earlier phases' numbers, printed beside
    these."""
    import asyncio

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.protocol import ResourceSet
    from ray_tpu_torch.llm import (EOS, ByteTokenizer, LLMConfig, LLMServer,
                                   build_openai_app)
    from ray_tpu_torch.llm import serving_patterns as sp
    from ray_tpu_torch.llm._engine import EngineConfig, PagedEngine

    out = {}
    tok = ByteTokenizer()
    model, overrides = APPS_MODEL
    config = LLMConfig(
        model_id=f"{model}-{APPS_LAYERS}-layers-random", model=model,
        seed=SEED, max_new_tokens=SERVE_MAX_TOKENS,
        model_overrides={k: getattr(torch, v) if k.endswith("dtype") else v
                         for k, v in overrides.items()})
    prompts = _apps_prompts(SEED + 2)
    ttft_prompts = _apps_prompts(SEED + 3)
    ids = [tok.encode(p) for p in prompts]
    _check([len(i) for i in ids] == list(SERVE_PROMPTS),
           f"apps: prompt lengths {[len(i) for i in ids]}")

    # the in-process references on the same weights: LLMServer (what the
    # openai app's replica runs) and the serve phase's PagedEngine
    t = time.monotonic()
    ref_server = LLMServer(config)
    cfg = ref_server.cfg
    want_batch = ref_server({"prompt": prompts,
                             "max_tokens": SERVE_MAX_TOKENS})
    # the chunks' choices (an SSE event carries a chunk of text: a token
    # that is not a byte adds none), the finish reason in the last
    want_stream = [c["choices"] for c in ref_server(
        {"prompt": prompts[0], "max_tokens": SERVE_MAX_TOKENS,
         "stream": True})]
    eng = PagedEngine(cfg, ref_server.params, EngineConfig(**RUNTIME_ECFG),
                      eos_id=EOS)

    async def engine_all():
        async def one(i):
            return [int(x) async for x in eng.generate_stream(
                i, max_tokens=SERVE_MAX_TOKENS, temperature=0.0, seed=SEED)]
        return await asyncio.gather(*[one(i) for i in ids])

    ref_engine = asyncio.run(engine_all())
    eng._worker.shutdown()
    del eng
    torch.cuda.empty_cache()
    out["reference_s"] = time.monotonic() - t
    print(f"apps: in-process references in {out['reference_s']:.2f} s; "
          f"dense tokens {want_batch['usage']['completion_tokens']} in all, "
          f"engine tokens {[len(x) for x in ref_engine]}, byte tokens "
          f"among them {sum(t < 256 for x in ref_engine for t in x)}",
          flush=True)

    os.environ["RT_GPU_AUTODETECT"] = "1"
    t0 = time.monotonic()
    rt.init(num_cpus=APPS_CPUS, system_config={
        "object_store_memory_bytes": APPS_STORE_BYTES,
        "serve_replica_init_timeout_s": APPS_INIT_TIMEOUT_S})
    out["cluster_start_s"] = time.monotonic() - t0
    from ray_tpu_torch._private.worker import global_context

    system_pids = [p.pid for p in global_context().owned_processes]
    session_dir = global_context().session_dir
    # every LLMConfig pickled here carries chip_smoke's counters to the
    # process that unpickles it (_apps_install); nothing else is changed
    LLMConfig.__reduce__ = _apps_config_reduce
    try:
        # 1. build_openai_app over HTTP: batched, then SSE-streamed
        t = time.monotonic()
        handle = build_openai_app(config, deployment_name="v1")
        base = serve.start(http_port=0)
        rep = handle.method("apps_report").remote(True).result(timeout=120)
        openai = dict(start_s=time.monotonic() - t,
                      replica_built_s=rep["built_at"] - t, base=base,
                      device=rep["device"], device_name=rep["device_name"])
        t = time.monotonic()
        got = _post_json(f"{base}/v1", {"prompt": prompts,
                                        "max_tokens": SERVE_MAX_TOKENS})
        openai["batch_s"] = time.monotonic() - t
        events, _ = _sse(f"{base}/v1", {"prompt": prompts[0],
                                         "max_tokens": SERVE_MAX_TOKENS,
                                         "stream": True})
        rep = handle.method("apps_report").remote().result(timeout=120)
        res = got["result"]
        chunks = [json.loads(e) for e in events[:-1]]
        streamed = "".join(c["choices"][0]["text"] for c in chunks)
        ttfts = [_sse(f"{base}/v1", {"prompt": p, "max_tokens": 1,
                                     "stream": True})[1]
                 for p in ttft_prompts]
        openai.update(
            k1_launches=rep["k1"], sse_events=len(events),
            texts_bytes=[len(c["text"].encode()) for c in res["choices"]],
            completion_tokens=res["usage"]["completion_tokens"],
            sse_ttft_s=ttfts, sse_ttft_p50_s=_ttft_p50(ttfts))
        out["openai"] = openai
        print(json.dumps({"apps_openai": openai}), flush=True)
        _check(rep["device"].startswith("cuda"),
               f"apps: the openai replica's model is on {rep['device']}")
        _check([c["text"] for c in res["choices"]]
               == [c["text"] for c in want_batch["choices"]]
               and [c["finish_reason"] for c in res["choices"]]
               == [c["finish_reason"] for c in want_batch["choices"]],
               f"apps: the HTTP batch's texts differ from the in-process "
               f"LLMServer's: {res['choices']} vs {want_batch['choices']}")
        _check(res["usage"]["completion_tokens"]
               == want_batch["usage"]["completion_tokens"],
               f"apps: the HTTP batch has {res['usage']['completion_tokens']}"
               f" completion tokens, the in-process LLMServer "
               f"{want_batch['usage']['completion_tokens']}")
        _check(events[-1] == "[DONE]"
               and [c["choices"] for c in chunks] == want_stream
               and streamed == res["choices"][0]["text"],
               f"apps: the SSE stream's chunks {[c['choices'] for c in chunks]}"
               f" differ from the in-process LLMServer's {want_stream} or "
               f"from the batch")
        serve.delete("v1")

        # 2. build_pd_app: a prefill worker's KV to a decode engine
        before = _app_actors()
        t = time.monotonic()
        handle = sp.build_pd_app(config, num_prefill=1, num_decode=1,
                                 deployment_name="pd",
                                 engine_config=RUNTIME_ECFG)
        rep = handle.method("apps_report").remote(True).result(timeout=600)
        pd = dict(start_s=time.monotonic() - t,
                  prefill_built_s=rep["prefill"][0]["built_at"] - t,
                  decode_built_s=rep["decode"][0]["built_at"] - t,
                  devices=[rep["prefill"][0]["device"],
                           rep["decode"][0]["device"]])
        t = time.monotonic()
        refs = [handle.remote({"prompt": p}) for p in prompts]
        outs = [r.result(timeout=600) for r in refs]
        pd["wall_s"] = time.monotonic() - t
        first = handle.method("apps_report").remote().result(timeout=120)
        again = handle.remote({"prompt": prompts[-1]}).result(timeout=600)
        rep = handle.method("apps_report").remote(True).result(timeout=120)
        handoffs = rep["prefill"][0]["handoffs"]
        bs = RUNTIME_ECFG["kv_block_size"]
        # k and v: layers x blocks x block tokens x kv heads x hd, bf16
        want_bytes = {n: 2 * cfg.n_layers * -(-n // bs) * bs
                      * cfg.n_kv_heads * cfg.head_dim * 2
                      for n in SERVE_PROMPTS}
        decoded = rep["decode"][0]["streams"]
        ttfts = []
        for p in ttft_prompts:
            t = time.monotonic()
            handle.remote({"prompt": p, "max_tokens": 1}).result(timeout=600)
            ttfts.append(time.monotonic() - t)
        late = handle.method("apps_report").remote().result(timeout=120)
        # the TTFT requests' prefills and decode streams (after the first
        # four prompts and the repeated one)
        late_h = late["prefill"][0]["handoffs"][len(prompts):]
        late_s = late["decode"][0]["streams"][len(prompts) + 1:]
        gaps = [s["start"] - h["end"] for h, s in zip(late_h, late_s)]
        shares = [g / ttft for g, ttft in zip(gaps, ttfts)]
        pd.update(
            k1_prefill=first["prefill"][0]["k1"],
            k1_decode=first["decode"][0]["k1"],
            k1_prefill_after_hit=rep["prefill"][0]["k1"],
            k1_decode_after_hit=rep["decode"][0]["k1"],
            handoff_bytes={h["tokens"]: h["bytes"] for h in handoffs},
            handoff_k_shape=max(h["k_shape"] for h in handoffs),
            handoff_s=gaps, prefill_s=[h["end"] - h["start"] for h in late_h],
            ttft_s=ttfts, ttft_p50_s=_ttft_p50(ttfts),
            handoff_share_of_ttft=shares,
            cache_hits=again["usage"]["prefill_cache_hits"],
            decode_replicas=[o["usage"]["decode_replica"] for o in outs]
            + [again["usage"]["decode_replica"]])
        out["pd"] = pd
        print(json.dumps({"apps_pd": pd}), flush=True)
        _check(all(d.startswith("cuda") for d in pd["devices"]),
               f"apps: the PD actors' models are on {pd['devices']}")
        # the decode engine's streams, by prompt (the first four in the
        # order the ingress reached it, then the repeated prompt's)
        by_prompt = {tuple(d["prompt"]): d for d in decoded[:len(prompts)]}
        for i, (o, want) in enumerate(zip(outs, ref_engine)):
            d = by_prompt.get(tuple(ids[i]), {})
            _check(o["choices"][0]["text"] == tok.decode(want)
                   and o["usage"]["completion_tokens"] == len(want)
                   and d.get("tokens") == want and d.get("prefilled"),
                   f"apps: PD request {i} ({SERVE_PROMPTS[i]} tokens) "
                   f"differs from the in-process engine's greedy tokens")
        _check(pd["k1_prefill"] == cfg.n_layers * len(prompts)
               and pd["k1_decode"] == 0,
               f"apps: K1 launched {pd['k1_prefill']} times in the prefill "
               f"worker and {pd['k1_decode']} in the decode engine, want "
               f"{cfg.n_layers * len(prompts)} and 0")
        _check(pd["k1_prefill_after_hit"] == pd["k1_prefill"]
               and pd["k1_decode_after_hit"] == 0 and pd["cache_hits"] == 1
               and len(handoffs) == len(prompts)
               and decoded[-1]["prompt"] == ids[-1]
               and decoded[-1]["tokens"] == ref_engine[-1]
               and again["usage"]["completion_tokens"] == len(ref_engine[-1])
               and pd["decode_replicas"][-1] == pd["decode_replicas"][-2],
               f"apps: the repeated prompt was not a prefill-cache hit on "
               f"the same decode replica: {pd}")
        _check(pd["handoff_bytes"] == want_bytes,
               f"apps: hand-off bytes {pd['handoff_bytes']}, want "
               f"{want_bytes}")
        _end_app("pd", before, [r["pid"] for r in late["prefill"]
                                + late["decode"]],
                 "the PD app's prefill worker and decode engine")

        # 3. build_dp_app: two engines, the prompts sent at once
        before = _app_actors()
        t = time.monotonic()
        handle = sp.build_dp_app(config, dp_size=2, deployment_name="dp",
                                 engine_config=RUNTIME_ECFG)
        rep = handle.method("apps_report").remote(True).result(timeout=600)
        dp = dict(start_s=time.monotonic() - t,
                  engines_built_s=[e["built_at"] - t
                                   for e in rep["engines"]],
                  devices=[e["device"] for e in rep["engines"]])
        t = time.monotonic()
        refs = [handle.remote({"prompt": p}) for p in prompts]
        outs = [r.result(timeout=600) for r in refs]
        wall = time.monotonic() - t
        rep = handle.method("apps_report").remote().result(timeout=120)
        streams = {tuple(s["prompt"]): s["tokens"]
                   for e in rep["engines"] for s in e["streams"]}
        ttfts = []
        for p in ttft_prompts:
            t = time.monotonic()
            handle.remote({"prompt": p, "max_tokens": 1}).result(timeout=600)
            ttfts.append(time.monotonic() - t)
        n_tokens = sum(o["usage"]["completion_tokens"] for o in outs)
        dp.update(k1_per_engine=[e["k1"] for e in rep["engines"]],
                  ranks=[o["usage"]["dp_rank"] for o in outs],
                  env_ranks=sorted(e["dp_rank"] for e in rep["engines"]),
                  wall_s=wall, tokens_out=n_tokens,
                  tokens_per_s=n_tokens / wall, ttft_s=ttfts,
                  ttft_p50_s=_ttft_p50(ttfts))
        out["dp"] = dp
        print(json.dumps({"apps_dp": dp}), flush=True)
        _check(all(d.startswith("cuda") for d in dp["devices"]),
               f"apps: the DP engines' models are on {dp['devices']}")
        _check(set(dp["ranks"]) == {0, 1} and dp["env_ranks"] == ["0", "1"],
               f"apps: DP ranks seen {dp['ranks']}, engines' "
               f"{dp['env_ranks']}")
        for i, (o, want) in enumerate(zip(outs, ref_engine)):
            _check(o["choices"][0]["text"] == tok.decode(want)
                   and o["usage"]["completion_tokens"] == len(want)
                   and streams.get(tuple(ids[i])) == want,
                   f"apps: DP request {i} ({SERVE_PROMPTS[i]} tokens) "
                   f"differs from the in-process engine's greedy tokens")
        _check(sum(dp["k1_per_engine"]) == cfg.n_layers * len(prompts),
               f"apps: K1 launched {dp['k1_per_engine']} times in the DP "
               f"engines, want {cfg.n_layers * len(prompts)} in all")
        _end_app("dp", before, [e["pid"] for e in rep["engines"]],
                 "the DP app's engines")
        out["launches"] = {"k1": pd["k1_prefill"] + pd["k1_decode"]
                           + sum(dp["k1_per_engine"])
                           + out["openai"]["k1_launches"]}

        # 4. a GPU lease through serve: 2 one-GPU replicas. The controller
        # places what fits and publishes demand for the rest on its
        # autoscaling path; a fixed num_replicas=2 would instead hold the
        # deploy on the second replica until the init timeout, then fail
        n_gpus = torch.cuda.device_count()
        lease = serve.run(serve.Deployment(
            _LeaseProbe, "lease", num_replicas=1,
            autoscaling_config={"min_replicas": 2, "max_replicas": 2},
            ray_actor_options={"num_gpus": 1}))
        seen = {}
        deadline = time.monotonic() + 60
        while len(seen) < min(2, n_gpus) and time.monotonic() < deadline:
            r = lease.remote().result(timeout=60)
            seen[r["pid"]] = r
            lease._refresh(force=True)
        demand, status = [], {}
        deadline = time.monotonic() + APPS_LEASE_WAIT_S
        while time.monotonic() < deadline:
            status = serve.status()["lease"]
            cw = rt.get_core_worker()
            load = cw.run_sync(cw.control.call("get_cluster_load", {}), 30)
            demand = [ResourceSet.from_wire(s).to_dict()
                      for s in load.get("reported_demand", [])]
            if n_gpus >= 2 or demand:
                break
            time.sleep(0.5)
        out["lease"] = dict(gpus=n_gpus, replicas_seen=list(seen.values()),
                            status=status, demand=demand)
        print(json.dumps({"apps_lease": out["lease"]}), flush=True)
        _check(all(r["device_count"] == 1 for r in seen.values()),
               f"apps: a 1-GPU replica sees {list(seen.values())}")
        if n_gpus == 1:
            _check(len(seen) == 1 and status.get("running") == 1,
                   f"apps: on one card {len(seen)} replicas answered, "
                   f"status {status}")
            _check(any(s.get("GPU") == 1.0 for s in demand),
                   f"apps: no GPU demand published for the pending "
                   f"replica: {demand}")
        else:
            _check(len(seen) == 2, f"apps: {len(seen)} of 2 replicas ran "
                   f"on {n_gpus} cards")
        serve.delete("lease")

        ttft = {k: out[k]["sse_ttft_p50_s" if k == "openai" else
                          "ttft_p50_s"] for k in ("openai", "pd", "dp")}
        ttft.update({
            "runtime_actor": report.get("runtime", {}).get(
                "serve", {}).get("ttft_p50_s", "not run"),
            "in_process_engine": report.get("serve", {}).get(
                "ttft_p50_s", "not run")})
        out["ttft_p50_s"] = ttft
        print(json.dumps({"apps_ttft_p50_s": ttft}), flush=True)
    finally:
        del LLMConfig.__reduce__
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            os.environ.pop("RT_GPU_AUTODETECT", None)
    del ref_server
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 30
    while (_cluster_pids(session_dir, system_pids)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    left = _cluster_pids(session_dir, system_pids)
    out["left_after_shutdown"] = left
    _check(not left, f"apps: processes left after shutdown: {left}")
    print("apps: shut down, no process of the cluster left", flush=True)
    return out


# the data phase: a streaming Dataset feeding the flagship's train step on
# the card, then batch_completions at Llama-3-8B
DATA_ROWS, DATA_BLOCKS = 88, 11    # 11 batches of 8: a warm-up, 10 timed
DATA_CPUS = 4
DATA_PROMPT_BLOCKS = 2             # map tasks of batch_completions
DATA_MAX_MODELS = 2                # 8B copies the map workers may build


def _data_tokens(batch):
    """``map_batches``: row id i becomes TRAIN_SEQ tokens of the
    flagship's vocab drawn from seed SEED + 100 + i."""
    import numpy as np

    return {"tokens": np.stack([np.random.RandomState(
        SEED + 100 + int(i)).randint(0, TRAIN_CFG["vocab_size"], TRAIN_SEQ)
        for i in batch["id"]])}


def _data_note(record_dir, entry):
    """One JSON line of what this process did, in ``record_dir`` (None:
    this script's own process, which reads its record in memory)."""
    if record_dir:
        with open(os.path.join(record_dir, f"{os.getpid()}.jsonl"),
                  "a") as f:
            f.write(json.dumps(dict(entry, pid=os.getpid())) + "\n")


def _data_install(record_dir):
    """chip_smoke's counters in a process that runs ``batch_completions``'
    map tasks (or in this script's process, ``record_dir`` None): each
    ``LLMServer`` built, and each prompt's token ids ``generate`` returned
    to it, noted in ``llm._chip_smoke_data`` and in ``record_dir``. Nothing they
    compute changes. Runs as the process unpickles the phase's
    ``LLMConfig`` (``_data_config``)."""
    import ray_tpu_torch.llm as llm

    if getattr(llm, "_chip_smoke_data", None) is not None:
        return
    rec = llm._chip_smoke_data = {"built": 0, "generated": []}
    init, gen = llm.LLMServer.__init__, llm.generate

    def __init__(self, *a, **kw):
        init(self, *a, **kw)
        rec["built"] += 1
        _data_note(record_dir, {"built": str(self.params["tok_emb"].device)})

    def generate(cfg, params, prompts, **kw):
        outs = gen(cfg, params, prompts, **kw)
        pairs = [[list(map(int, p)), list(map(int, o))]
                 for p, o in zip(prompts, outs)]
        rec["generated"] += pairs
        _data_note(record_dir, {"generated": pairs})
        return outs

    llm.LLMServer.__init__ = __init__
    llm.generate = generate


def _data_config(fields, record_dir):
    """Unpickles the data phase's ``LLMConfig``: first installs
    chip_smoke's counters in this process (``_data_install``)."""
    _data_install(record_dir)
    from ray_tpu_torch.llm import LLMConfig

    return LLMConfig(**fields)


_DATA_RECORD_DIR = None


def _data_config_reduce(self):
    import dataclasses

    return (_data_config, ({f.name: getattr(self, f.name)
                            for f in dataclasses.fields(self)},
                           _DATA_RECORD_DIR))


def _data_train(dev, cfg, feed, profile_feed=None):
    """The flagship from seed SEED, a warm-up and then DATA_BLOCKS - 1
    timed steps on the batches ``feed()`` returns one by one: every loss,
    step ms, host ms spent in ``feed``, K1-K3 launches of the timed steps,
    peak memory, the batches' dtype / device / shape; with
    ``profile_feed`` (made after the timed steps: a function that gives
    batches), one profiled step, its batch fetched inside it."""
    import torch

    from ray_tpu_torch.models.llama import make_train_step
    from ray_tpu_torch.ops import flash_attention as fa

    init_state, shard_state, train_step, _ = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0)
    state = shard_state(init_state(SEED))
    state, loss = train_step(state, feed())  # warm-up: cuBLAS, kernels
    losses = [loss]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = DATA_BLOCKS - 1
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    feed_s, seen = 0.0, set()
    t = time.monotonic()
    for _ in range(steps):
        t_feed = time.monotonic()
        tokens = feed()
        feed_s += time.monotonic() - t_feed
        seen.add((str(tokens.dtype), tokens.device.type,
                  tuple(tokens.shape)))
        state, loss = train_step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.monotonic() - t) / steps
    launches = dict(k1=fa.flash_fwd_launches, k2=fa.flash_bwd_dq_launches,
                    k3=fa.flash_bwd_dkv_launches)
    out = dict(losses=[float(x) for x in losses], step_ms=dt * 1e3,
               feed_host_ms=feed_s / steps * 1e3,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / dt,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()},
               batches=sorted(seen))
    if profile_feed is not None:
        fetch = profile_feed()
        out["profile"] = _train_profile(
            lambda s: train_step(s, fetch()), state)
    del state
    torch.cuda.empty_cache()
    return out


def phase_data(dev):
    """The port's data library on the card (see the module docstring):
    (a) a streaming Dataset through ``iter_batches(device_put=True)``
    into the flagship's train step, against the same batches moved by
    ``.to(dev)``; (b) ``batch_completions`` at Llama-3-8B against the
    in-process ``LLMServer``."""
    global _DATA_RECORD_DIR
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rdata
    import ray_tpu_torch.llm as llm
    from ray_tpu_torch.llm import (ByteTokenizer, LLMConfig, LLMServer,
                                   batch_completions)
    from ray_tpu_torch.models.llama import LlamaConfig

    out = {}
    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    _check(DATA_ROWS == DATA_BLOCKS * TRAIN_BATCH,
           "data: the blocks must be the batches")
    # (a) the reference first: the same batches made here, moved by .to()
    made = [_data_tokens({"id": np.arange(k * TRAIN_BATCH,
                                          (k + 1) * TRAIN_BATCH)})["tokens"]
            for k in range(DATA_BLOCKS)]
    on_card = iter([torch.from_numpy(b).to(dev) for b in made])
    direct = _data_train(dev, cfg, lambda: next(on_card))
    print(json.dumps({"data_direct": direct}), flush=True)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    t0 = time.monotonic()
    rt.init(num_cpus=DATA_CPUS)
    out["cluster_start_s"] = time.monotonic() - t0
    from ray_tpu_torch._private.worker import global_context

    system_pids = [p.pid for p in global_context().owned_processes]
    session_dir = global_context().session_dir
    try:
        ds = rdata.range(DATA_ROWS, parallelism=DATA_BLOCKS).map_batches(
            _data_tokens)  # not materialized: it streams
        it = ds.iter_batches(batch_size=TRAIN_BATCH, device_put=True)

        def profile_feed():
            again = ds.iter_batches(batch_size=TRAIN_BATCH, device_put=True)
            next(again)  # the profiled step's pipeline, already streaming
            return lambda: next(again)["tokens"]

        fed = _data_train(dev, cfg, lambda: next(it)["tokens"],
                          profile_feed=profile_feed)
        out["train"] = fed
        out["launches"] = fed["launches"]
        _check(next(it, None) is None,
               f"data: more than {DATA_BLOCKS} batches")
        # next()'s host time split: the copy to the card alone (the cast
        # into pinned memory and the non-blocking copy) on a batch here
        from ray_tpu_torch.data.dataset import _put_column

        t = time.monotonic()
        for b in made:
            _put_column(b, dev)
        fed["put_host_ms"] = (time.monotonic() - t) / len(made) * 1e3
        torch.cuda.synchronize()
        prof = fed["profile"]
        print(f"data: step {fed['step_ms']:.2f} ms fed by iter_batches "
              f"against {direct['step_ms']:.2f} ms from tensors on the "
              f"card; {fed['feed_host_ms']:.3f} ms of host time in next() "
              f"a batch, {fed['put_host_ms']:.3f} ms of it the copy to the "
              f"card; device idle {prof.get('device_idle_share')} of a "
              f"profiled step; peak {fed['peak_memory_gb']:.2f} GB",
              flush=True)
        _check(fed["losses"] == direct["losses"],
               f"data: losses fed by iter_batches {fed['losses']} are not "
               f"bitwise the direct ones {direct['losses']}")
        _check(all(np.isfinite(fed["losses"])),
               f"data: losses not finite: {fed['losses']}")
        _check(fed["batches"] == [("torch.int32", "cuda",
                                   (TRAIN_BATCH, TRAIN_SEQ))],
               f"data: batches on the device were {fed['batches']}, want "
               f"int32 on cuda as JAX's device_put gives")
        want = dict(k1=2 * cfg.n_layers, k2=cfg.n_layers, k3=cfg.n_layers)
        _check(fed["launches_per_step"] == want,
               f"data: launches a step {fed['launches_per_step']}, want "
               f"{want}")

        # (b) batch_completions: the in-process server first, on the
        # blocks the map tasks get (from_items cuts 4 rows into 2 x 2)
        torch.cuda.empty_cache()
        model, overrides = APPS_MODEL
        config = LLMConfig(
            model_id=f"{model}-{APPS_LAYERS}-layers-random", model=model,
            seed=SEED,
            max_new_tokens=SERVE_MAX_TOKENS,
            model_overrides={k: getattr(torch, v) if k.endswith("dtype")
                             else v for k, v in overrides.items()})
        prompts = _apps_prompts(SEED + 2)
        tok = ByteTokenizer()
        _check([len(tok.encode(p)) for p in prompts] == list(SERVE_PROMPTS),
               "data: prompt lengths")
        per = len(prompts) // DATA_PROMPT_BLOCKS
        blocks = [prompts[i:i + per] for i in range(0, len(prompts), per)]
        _data_install(None)
        t = time.monotonic()
        ref_server = LLMServer(config)
        ref_texts = [c["text"] for b in blocks
                     for c in ref_server({"prompt": b})["choices"]]
        ref_ids = {tuple(p): o for p, o in llm._chip_smoke_data["generated"]}
        whole = ref_server({"prompt": prompts})["choices"]
        whole_ids = llm._chip_smoke_data["generated"][len(prompts):]
        out["reference_s"] = time.monotonic() - t
        del ref_server
        torch.cuda.empty_cache()

        _DATA_RECORD_DIR = tmp
        LLMConfig.__reduce__ = _data_config_reduce
        try:
            pds = rdata.from_items([{"prompt": p} for p in prompts],
                                   parallelism=DATA_PROMPT_BLOCKS)
            t = time.monotonic()
            rows = batch_completions(config, pds).take_all()
            out["batch_completions_s"] = time.monotonic() - t
        finally:
            del LLMConfig.__reduce__
            _DATA_RECORD_DIR = None
        notes = []
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name)) as f:
                notes += [json.loads(line) for line in f]
        built = [n for n in notes if "built" in n]
        got_ids = {tuple(p): o for n in notes
                   for p, o in n.get("generated", [])}
        out["batch"] = dict(
            rows=len(rows), texts_bytes=[len(str(r["completion"]).encode())
                                         for r in rows],
            workers_built=sorted({n["pid"] for n in built}),
            models_built=len(built), model_devices=sorted(
                {n["built"] for n in built}),
            tokens=[len(got_ids.get(tuple(tok.encode(p)), []))
                    for p in prompts],
            whole_batch_ids_equal=[list(tok.encode(p)) == w[0] and
                                   ref_ids[tuple(tok.encode(p))] == w[1]
                                   for p, w in zip(prompts, whole_ids)],
            whole_batch_texts_equal=[c["text"] for c in whole] == ref_texts)
        print(json.dumps({"data_batch_completions": dict(
            out["batch"], seconds=out["batch_completions_s"],
            reference_s=out["reference_s"])}), flush=True)
        _check(len(rows) == len(prompts),
               f"data: {len(rows)} rows, want {len(prompts)}")
        _check([str(r["prompt"]) for r in rows] == prompts
               and [str(r["completion"]) for r in rows] == ref_texts,
               "data: batch_completions' rows are not the in-process "
               "server's completions")
        _check(out["batch"]["whole_batch_texts_equal"],
               "data: batch_completions' texts are not the in-process "
               "server's given all the prompts at once")
        _check(set(got_ids) == set(ref_ids) and all(
            got_ids[k] == ref_ids[k] for k in ref_ids),
               "data: the token ids the map workers generated are not the "
               "in-process server's")
        _check(1 <= len(out["batch"]["workers_built"]) <= DATA_MAX_MODELS
               and len(built) == len(out["batch"]["workers_built"]),
               f"data: models built {built}, want one a worker and at most "
               f"{DATA_MAX_MODELS}")
        _check(out["batch"]["model_devices"] == ["cuda:0"],
               f"data: map workers built on {out['batch']['model_devices']}")
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.monotonic() + 30
    while (_cluster_pids(session_dir, system_pids)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    left = _cluster_pids(session_dir, system_pids)
    _check(not left, f"data: processes left after shutdown: {left}")
    print("data: shut down, no process of the cluster left", flush=True)
    return out


# the algos phase: the rllib algorithms, runners on the CPU, learners here
ALGOS_CPUS = 4
ALGOS_RUNNERS = 2
ALGOS_FRAGMENT = 200       # env steps a runner an iteration (as JAX's test)
ALGOS_ITERS = 5
ALGOS_OFFLINE_ROWS = 4096
ALGOS_OFFLINE_EPOCHS = 3
ALGOS_HELD_OUT = 256
ALGOS_AGREE_MIN = 1.0      # greedy == expert on every held-out observation
ALGOS_MAPPINGS = {"independent": (("a0", "a1"), {}),
                  "shared": (("shared",), {"a0": "shared", "a1": "shared"})}


def _matching_env():
    """``test_rllib_multi_agent.py``'s cooperative matching game (its
    ``make_matching_env``; ``tests/_rl_envs.py`` holds the tests' copy):
    two agents see one random bit and earn +1 each when both play it; 20
    steps an episode, optimum 40, random play ~10. A factory: the runners
    get it by value."""
    import numpy as _np

    class MatchingEnv:
        agents = ("a0", "a1")

        def __init__(self, episode_len=20):
            self.episode_len = episode_len
            self._rng = _np.random.default_rng(0)
            self._t = 0
            self._bit = 0

        def _obs(self):
            v = _np.asarray([self._bit, 1 - self._bit], _np.float32)
            return {a: v for a in self.agents}

        def reset(self, seed=None):
            if seed is not None:
                self._rng = _np.random.default_rng(seed)
            self._t = 0
            self._bit = int(self._rng.integers(2))
            return self._obs(), {}

        def step(self, actions):
            hit = all(actions[a] == self._bit for a in self.agents)
            rew = {a: (1.0 if hit else 0.0) for a in self.agents}
            self._t += 1
            self._bit = int(self._rng.integers(2))
            done = self._t >= self.episode_len
            terms = {a: done for a in self.agents}
            truncs = {a: False for a in self.agents}
            return self._obs(), rew, terms, truncs, {}

    return MatchingEnv()


def _matching_rows(n, seed, eps):
    """``n`` transitions of agent a0 under the game's scripted expert (play
    the bit; the partner does too), each action uniform with probability
    ``eps`` (``tests/_rl_envs.py::matching_expert_rows``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    env = _matching_env()
    obs, _ = env.reset(seed=seed)
    rows = []
    for _ in range(n):
        bit = int(obs["a0"][0])
        a = bit if rng.random() >= eps else int(rng.integers(2))
        nxt, rew, terms, _, _ = env.step({"a0": a, "a1": bit})
        rows.append({"obs": np.asarray(obs["a0"], np.float32), "action": a,
                     "reward": float(rew["a0"]),
                     "next_obs": np.asarray(nxt["a0"], np.float32),
                     "terminated": float(terms["a0"])})
        obs = nxt
        if terms["a0"]:
            obs, _ = env.reset()
    return rows


def _timed_updates(learner, record, dev):
    """Wrap ``learner.update``: a copy of each batch it is handed (a dict:
    PPO's, CQL's) goes to ``record["batches"]``, each call's seconds (the
    card synchronised) to ``record["_s"]``."""
    import torch

    update = learner.update

    def timed(*a, **kw):
        if isinstance(a[0], dict):
            record.setdefault("batches", []).append(
                {k: v.copy() for k, v in a[0].items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.monotonic()
        out = update(*a, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        record.setdefault("_s", []).append(time.monotonic() - t)
        return out

    learner.update = timed


def _algos_multi_agent(dev, mapping, session_dir, system_pids):
    """MultiAgentPPO with ``mapping``: ALGOS_ITERS iterations with the
    learners on ``dev``, the first against the same config on the CPU from
    the same weights (the runners' seeds are the config's in both); which
    of the cluster's worker processes imported torch, and which hold the
    card's device files, while the runners live."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib import MultiAgentPPOConfig
    from ray_tpu_torch.rllib.learner import leaves

    pids, pmap = ALGOS_MAPPINGS[mapping]
    spec = {"obs_dim": 2, "num_actions": 2, "hidden": (32, 32)}

    def build(device):
        return (MultiAgentPPOConfig().environment(_matching_env)
                .multi_agent(policies={p: dict(spec) for p in pids},
                             policy_mapping=pmap)
                .env_runners(num_env_runners=ALGOS_RUNNERS,
                             rollout_fragment_length=ALGOS_FRAGMENT)
                .training(lr=3e-3, device=device).build())

    card, host = build(dev), build("cpu")
    rec = {"card": {p: {} for p in pids}, "cpu": {p: {} for p in pids}}
    try:
        host.set_weights(card.get_weights())
        for algo, side, d in ((card, "card", dev),
                              (host, "cpu", torch.device("cpu"))):
            for p, ln in algo.learners.items():
                _timed_updates(ln, rec[side][p], d)
        learner_devices = sorted({str(t.device) for ln in
                                  card.learners.values()
                                  for t in leaves(ln.params)})
        t = time.monotonic()
        results = [card.train()]
        iter_s = [time.monotonic() - t]
        w1_card = card.get_weights()
        first_cpu = host.train()
        w1_cpu = host.get_weights()
        host.stop()
        host = None
        for _ in range(ALGOS_ITERS - 1):
            t = time.monotonic()
            results.append(card.train())
            iter_s.append(time.monotonic() - t)
        workers = [p for p in _cluster_pids(session_dir)
                   if p != os.getpid() and p not in system_pids]
        with_torch = [p for p in workers if _maps_hold(p, "libtorch")]
        first = {p: (rec["card"][p]["batches"][0],
                     rec["cpu"][p]["batches"][0]) for p in pids}
        batches_equal = all(
            a.keys() == b.keys()
            and all(np.array_equal(a[k], b[k]) for k in a)
            for a, b in first.values())
        env_steps = ALGOS_RUNNERS * ALGOS_FRAGMENT
        steady = float(np.mean(iter_s[1:]))
        return dict(
            mapping=mapping, policies=list(pids),
            learner_devices=learner_devices, iterations=len(results),
            ms_per_iteration=1e3 * steady,
            first_iteration_ms=1e3 * iter_s[0],
            learner_ms_per_update={
                p: 1e3 * float(np.mean(rec["card"][p]["_s"][1:]))
                for p in pids},
            learner_first_update_ms={
                p: 1e3 * rec["card"][p]["_s"][0] for p in pids},
            env_steps_per_iteration=env_steps,
            env_steps_per_s=env_steps / steady,
            rows_per_policy_batch={p: len(first[p][0]["obs"])
                                   for p in pids},
            episode_return_mean=[r["episode_return_mean"] for r in results],
            batches_equal=batches_equal,
            first_iteration_weight_rel_err=_rel_errors(w1_card, w1_cpu),
            first_iteration_metrics={
                "card": {k: v for k, v in results[0].items() if "/" in k},
                "cpu": {k: v for k, v in first_cpu.items() if "/" in k}},
            finite=all(np.isfinite(v) for r in results
                       for k, v in r.items() if "/" in k),
            workers_with_torch=with_torch,
            # ``import torch`` maps CUDA's driver library; a context opens
            # the device files
            workers_mapping_libcuda=[p for p in with_torch
                                     if _maps_hold(p, "libcuda.so")],
            runners_on_cuda={p: _nvidia_handles(p) for p in with_torch
                             if _nvidia_handles(p)},
            driver_handles=_nvidia_handles(os.getpid()))
    finally:
        card.stop()
        if host is not None:
            host.stop()


def _algos_offline(dev, kind):
    """BC or CQL from a Dataset of the matching game's expert transitions,
    its learner on ``dev``: ALGOS_OFFLINE_EPOCHS epochs, then the share of
    held-out seeded observations where its greedy action is the expert's."""
    import numpy as np

    import ray_tpu_torch.data as rtd
    import ray_tpu_torch.rllib as tr
    from ray_tpu_torch.rllib.learner import leaves

    eps = 0.0 if kind == "BC" else 0.2
    rows = _matching_rows(ALGOS_OFFLINE_ROWS, SEED, eps)
    ds = rtd.from_items(rows, parallelism=4)
    algo = getattr(tr, f"{kind}Config")().offline_data(ds).training(
        device=dev).build()
    rec = {}
    _timed_updates(algo.learner, rec, dev)
    results = [algo.train() for _ in range(ALGOS_OFFLINE_EPOCHS)]
    bits = np.random.default_rng(SEED + 17).integers(0, 2, ALGOS_HELD_OUT)
    obs = np.stack([bits, 1 - bits], axis=1).astype(np.float32)
    acts = np.array([algo.learner.act(o) for o in obs])
    return dict(
        kind=kind, rows=len(rows), random_action_share=eps,
        epochs=len(results),
        learner_devices=sorted({str(t.device)
                                for t in leaves(algo.learner.params)}),
        samples_per_s=[r["samples_per_s"] for r in results],
        learner_ms_per_update=1e3 * float(np.mean(rec["_s"][1:])),
        updates=len(rec["_s"]),
        last={k: v for k, v in results[-1].items()
              if k not in ("samples_per_s",)},
        agreement=float((acts == bits).mean()))


# the algos phase's heartbeat watch (a node's health check once timed out
# there: 10 s without a beat, on a slower host)
WATCH_PERIOD_S = 0.2
WATCH_LATE_S = 3.0         # a beat this late (3 periods) takes stacks
WATCH_DUMPS = 3
_STACKS_HOOK = """\
import faulthandler, os, signal
_d = os.environ.get("CHIP_SMOKE_STACKS")
if _d:
    _f = open(os.path.join(_d, "%d.stacks" % os.getpid()), "a")
    faulthandler.register(signal.SIGUSR1, file=_f, all_threads=True)
    open(os.path.join(_d, "%d.ready" % os.getpid()), "w").close()
"""


def _proc_stat(pid):
    """(state, CPU seconds) of ``pid`` from /proc, (None, None) if gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None, None
    tick = os.sysconf("SC_CLK_TCK")
    return fields[0], (int(fields[11]) + int(fields[12])) / tick


def _host_cpu():
    """(busy, total) jiffies of all CPUs, and the runnable tasks, from
    /proc/stat."""
    busy = total = running = 0
    with open("/proc/stat") as f:
        for line in f:
            if line.startswith("cpu "):
                v = [int(x) for x in line.split()[1:]]
                total = sum(v[:8])
                busy = total - v[3] - v[4]   # less idle and iowait
            elif line.startswith("procs_running"):
                running = int(line.split()[1])
    return busy, total, running


def _threads(pid):
    """Each thread of ``pid``: its name, state and kernel wait channel."""
    out = []
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tids:
        row = {"tid": int(tid)}
        for key, name in (("comm", "comm"), ("wchan", "wchan")):
            try:
                with open(f"/proc/{pid}/task/{tid}/{name}") as f:
                    row[key] = f.read().strip()
            except OSError:
                pass
        row["state"] = _proc_stat(f"{pid}/task/{tid}")[0]
        out.append(row)
    return out


class _BeatWatch:
    """Watches the node's heartbeats from a thread of this process while
    the algos phase runs. Every WATCH_PERIOD_S: the age of the node's last
    beat as the control store stamped it (``get_node_stats``' ``ts``), the
    round trips of that call (the store's loop) and of ``list_workers`` to
    the node daemon (the daemon's loop), the slowest read of a listed
    worker's ``/proc/<pid>/statm`` (what the daemon's ``_node_stats`` reads
    on its loop each beat), how late this thread's own sleep
    woke (the host's scheduler), the load average, and the CPU seconds of
    the daemon and the store. A beat WATCH_LATE_S late takes, up to
    WATCH_DUMPS times, both processes' Python stacks (SIGUSR1 to the
    faulthandler ``_STACKS_HOOK`` registered at their start) and their
    threads' states and wait channels."""

    def __init__(self, rt, pids, stacks_dir):
        from ray_tpu_torch.runtime.rpc import RpcClient

        self.rt, self.pids, self.dir = rt, pids, stacks_dir
        self.cw = rt.get_core_worker()
        self.node = rt.nodes()[0]
        address = self.node["address"]

        async def connect():
            c = RpcClient(address, name="chip_smoke->daemon")
            await c.connect()
            return c

        self.daemon = self.cw.run_sync(connect(), 30)
        self.samples, self.dumps, self.errors = [], [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="beat-watch")

    def start(self):
        self._thread.start()
        return self

    async def _timed(self, call):
        t = time.monotonic()
        reply = await call
        return reply, time.monotonic() - t

    def _sample(self):
        node = self.node["node_id"]
        t = time.monotonic()
        stats, store_rtt = self.cw.run_sync(self._timed(
            self.cw.control.call("get_node_stats", {})), 30)
        workers, daemon_rtt = self.cw.run_sync(self._timed(
            self.daemon.call("list_workers", {}, timeout=30)), 35)
        # the reads the daemon's _node_stats makes on its loop every beat
        # (psutil's memory_info: /proc/<pid>/statm of each worker)
        statm = 0.0
        for w in workers["workers"]:
            t0 = time.monotonic()
            try:
                with open(f"/proc/{w['pid']}/statm") as f:
                    f.read()
            except OSError:
                pass
            statm = max(statm, time.monotonic() - t0)
        row = stats["stats"].get(node) or {}
        with open("/proc/loadavg") as f:
            load = float(f.read().split()[0])
        cpu = {k: _proc_stat(p)[1] for k, p in self.pids.items()}
        busy, total, running = _host_cpu()
        return dict(t=t, beat_age_s=time.time() - row.get("ts", 0.0),
                    store_rtt_s=store_rtt, daemon_rtt_s=daemon_rtt,
                    statm_s=statm, workers=len(workers["workers"]),
                    call_s=time.monotonic() - t, load1=load, cpu_s=cpu,
                    host_busy=busy, host_total=total, runnable=running)

    def _dump(self, why):
        marks = {k: os.path.exists(os.path.join(self.dir, f"{p}.ready"))
                 for k, p in self.pids.items()}
        dump = dict(why=why, threads={k: _threads(p)
                                      for k, p in self.pids.items()},
                    hooked=marks)
        for k, p in self.pids.items():
            if marks[k]:  # SIGUSR1 ends a process that did not register it
                os.kill(p, signal.SIGUSR1)
        time.sleep(0.5)
        for k, p in self.pids.items():
            try:
                with open(os.path.join(self.dir, f"{p}.stacks")) as f:
                    dump[f"{k}_stacks"] = f.read()[-20000:]
            except OSError:
                pass
        self.dumps.append(dump)

    def _run(self):
        last = time.monotonic()
        while not self._stop.wait(WATCH_PERIOD_S):
            woke = time.monotonic()
            try:
                row = self._sample()
            except Exception as e:  # noqa: BLE001 — recorded, then go on
                self.errors.append(f"{time.monotonic():.3f}: {e!r}")
                row = None
            if row is not None:
                row["oversleep_s"] = woke - last - WATCH_PERIOD_S
                self.samples.append(row)
                late = max(row["beat_age_s"], row["store_rtt_s"],
                           row["daemon_rtt_s"])
                if late >= WATCH_LATE_S and len(self.dumps) < WATCH_DUMPS:
                    self._dump(row)
            last = time.monotonic()

    def stop(self) -> dict:
        """Ends the watch: the summary (maxima, CPU shares, dumps)."""
        self._stop.set()
        self._thread.join(30)
        try:
            self.cw.run_sync(self.daemon.close(), 10)
        except Exception:  # noqa: BLE001 — the cluster may be gone
            pass
        rows = self.samples
        if not rows:
            return dict(samples=0, errors=self.errors[-5:])
        span = rows[-1]["t"] - rows[0]["t"] or 1.0
        share = {k: ((rows[-1]["cpu_s"][k] or 0.0)
                     - (rows[0]["cpu_s"][k] or 0.0)) / span
                 for k in self.pids}
        worst = max(rows, key=lambda r: r["beat_age_s"])
        # the host's CPUs busy between consecutive samples (all CPUs = 1)
        busy = [(b["host_busy"] - a["host_busy"])
                / max(1, b["host_total"] - a["host_total"])
                for a, b in zip(rows, rows[1:])]
        return dict(
            samples=len(rows), seconds=span,
            beat_age_max_s=worst["beat_age_s"],
            store_rtt_max_s=max(r["store_rtt_s"] for r in rows),
            daemon_rtt_max_s=max(r["daemon_rtt_s"] for r in rows),
            statm_max_s=max(r["statm_s"] for r in rows),
            workers_max=max(r["workers"] for r in rows),
            oversleep_max_s=max(r["oversleep_s"] for r in rows),
            load1_max=max(r["load1"] for r in rows),
            host_busy_mean=((rows[-1]["host_busy"] - rows[0]["host_busy"])
                            / max(1, rows[-1]["host_total"]
                                  - rows[0]["host_total"])),
            host_busy_max=max(busy, default=None),
            runnable_max=max(r["runnable"] for r in rows),
            cpu_share=share, cpus=os.cpu_count(),
            cpus_usable=len(os.sched_getaffinity(0)),
            late=sum(1 for r in rows if r["beat_age_s"] >= WATCH_LATE_S),
            worst=worst, dumps=self.dumps, errors=self.errors[-5:])


def phase_algos(dev, card=""):
    """The rllib algorithms on the port's cluster: env runners as actors on
    the CPU, learners on the card (see the module docstring); ``card``,
    nvidia-smi's name and power limit, stands beside each time printed."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_context

    _check(not torch.backends.cuda.matmul.allow_tf32,
           "algos: TF32 products are on; the learners compute in fp32")
    out = {"card": card}
    # the control store and the daemon start with _STACKS_HOOK, which lets
    # the heartbeat watch take their stacks
    stacks = tempfile.mkdtemp(prefix="chip_smoke_stacks_")
    with open(os.path.join(stacks, "sitecustomize.py"), "w") as f:
        f.write(_STACKS_HOOK)
    env_before = {k: os.environ.get(k)
                  for k in ("PYTHONPATH", "CHIP_SMOKE_STACKS")}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [stacks, os.path.dirname(os.path.abspath(__file__))]
        + ([env_before["PYTHONPATH"]] if env_before["PYTHONPATH"] else []))
    os.environ["CHIP_SMOKE_STACKS"] = stacks
    t0 = time.monotonic()
    try:
        rt.init(num_cpus=ALGOS_CPUS)
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["cluster_start_s"] = time.monotonic() - t0
    owned = global_context().owned_processes
    system_pids = [p.pid for p in owned]
    session_dir = global_context().session_dir
    watch = None
    try:
        watch = _BeatWatch(rt, {"control_store": owned[0].pid,
                                "daemon": owned[-1].pid}, stacks).start()
        for mapping in ALGOS_MAPPINGS:
            row = _algos_multi_agent(dev, mapping, session_dir,
                                     system_pids)
            out[f"multi_agent_{mapping}"] = row
            print(f"algos ({card}): MultiAgentPPO {mapping}: "
                  f"{row['ms_per_iteration']:.1f} ms an iteration, "
                  f"{row['env_steps_per_s']:.0f} env steps/s, learner "
                  f"{row['learner_ms_per_update']} ms an update on the "
                  f"card; first iteration's weights within "
                  f"{row['first_iteration_weight_rel_err']:.2e} of the "
                  f"CPU's", flush=True)
        for kind in ("BC", "CQL"):
            row = _algos_offline(dev, kind)
            out[kind.lower()] = row
            print(f"algos ({card}): {kind}: "
                  f"{row['learner_ms_per_update']:.3f} ms an "
                  f"update on the card, {row['samples_per_s'][-1]:.0f} "
                  f"samples/s, greedy == expert on "
                  f"{row['agreement']:.3f} of {ALGOS_HELD_OUT}", flush=True)
    finally:
        if watch is not None:
            beats = out["beats"] = watch.stop()
            print(json.dumps({"algos_beats": beats}, default=str),
                  flush=True)
            if beats["samples"]:
                print(f"algos ({card}): heartbeats: the store's last beat "
                      f"at most {beats['beat_age_max_s']:.2f} s old, round "
                      f"trips store {beats['store_rtt_max_s']:.3f} s, "
                      f"daemon {beats['daemon_rtt_max_s']:.3f} s; a "
                      f"worker's /proc statm read {beats['statm_max_s']:.4f}"
                      f" s at most ({beats['workers_max']} workers); this "
                      f"process overslept {beats['oversleep_max_s']:.3f} s "
                      f"at most; load {beats['load1_max']:.1f}, host CPUs "
                      f"busy {beats['host_busy_mean']:.2f} (max "
                      f"{beats['host_busy_max']}), runnable tasks at most "
                      f"{beats['runnable_max']} on {beats['cpus_usable']} "
                      f"CPUs; CPU share "
                      f"{beats['cpu_share']}; {beats['late']} late samples, "
                      f"{len(beats['dumps'])} stack dumps", flush=True)
        rt.shutdown()
        shutil.rmtree(stacks, ignore_errors=True)
    deadline = time.monotonic() + 30
    while (_cluster_pids(session_dir, system_pids)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    out["left_after_shutdown"] = _cluster_pids(session_dir, system_pids)
    print(json.dumps({"algos": out}), flush=True)
    _check(not out["left_after_shutdown"],
           f"algos: processes left after shutdown: "
           f"{out['left_after_shutdown']}")
    for mapping in ALGOS_MAPPINGS:
        row = out[f"multi_agent_{mapping}"]
        _check(row["learner_devices"] == ["cuda:0"],
               f"algos: {mapping}: learners on {row['learner_devices']}")
        _check(row["batches_equal"],
               f"algos: {mapping}: the first batches differ between the "
               "card's and the CPU's run")
        _check(row["first_iteration_weight_rel_err"] <= TOL_RL,
               f"algos: {mapping}: first iteration's weights "
               f"{row['first_iteration_weight_rel_err']:.3e} from the CPU's "
               f"(TOL_RL {TOL_RL})")
        _check(row["finite"] and row["iterations"] == ALGOS_ITERS,
               f"algos: {mapping}: {row}")
        _check(len(row["workers_with_torch"]) >= ALGOS_RUNNERS
               and not row["runners_on_cuda"]
               and (dev.type != "cuda" or row["driver_handles"]),
               f"algos: {mapping}: of the workers that imported torch "
               f"{row['workers_with_torch']}, these hold the card's device "
               f"files: {row['runners_on_cuda']} (this process, whose "
               f"learners use the card: {row['driver_handles']})")
    for kind in ("bc", "cql"):
        row = out[kind]
        _check(row["learner_devices"] == ["cuda:0"]
               and row["agreement"] >= ALGOS_AGREE_MIN,
               f"algos: {kind}: {row}")
    return out


# The device object plane and the collective groups on the card
# (util/collective, experimental/rdt.py, experimental/device_channel.py,
# gpu/slice.py): one cluster, as a user's program would hold one
COLLECTIVE_CPUS = 4
COLLECTIVE_STORE_BYTES = 1 << 30   # the 256 MiB put, and its rebuild's read
COLLECTIVE_TENSOR_SHAPE = RUNTIME_TENSOR_SHAPE   # bf16: 256 MiB
COLLECTIVE_WORLD = 2
COLLECTIVE_ROWS = (4, 1 << 20)     # fp32, integer-valued: 16 MiB a rank
COLLECTIVE_CHANNEL_SHAPE = (4096, 4096)   # bf16: 32 MiB a transfer
COLLECTIVE_CHANNEL_SENDS = 3
COLLECTIVE_OPS = ("sum", "product", "max", "min")


def _collective_rows(rank):
    """Rank ``rank``'s integer-valued fp32 rows in [-3, 3], so every op of
    two ranks is exact in fp32 (a product of two is at most 9)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 40 + rank)
    return rng.integers(-3, 4, COLLECTIVE_ROWS).astype(np.float32)


class _GlooMember:
    """A num_gpus=0.5 rank of a gloo group carrying CUDA tensors (staged
    through host memory): every op and send/recv against the numpy twin,
    then the device channel's transfers."""

    def __init__(self, rank):
        self.rank = rank

    def run(self, group):
        import functools

        import numpy as np
        import torch

        from ray_tpu_torch.experimental.device_channel import DeviceChannel
        from ray_tpu_torch.util import collective as col

        dev = torch.device("cuda", 0)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
        rank, world = self.rank, COLLECTIVE_WORLD
        t0 = time.monotonic()
        col.init_collective_group(world, rank, backend="gloo",
                                  group_name=group)
        init_s = time.monotonic() - t0
        xs = [_collective_rows(r) for r in range(world)]
        x = torch.from_numpy(xs[rank]).to(dev)
        keep = x.clone()
        npop = {"sum": np.add, "product": np.multiply, "max": np.maximum,
                "min": np.minimum}
        checks = {}

        def check(name, got, want, device="cuda"):
            checks[name] = (got.device.type == device and bool(np.array_equal(
                got.cpu().numpy(), want)), str(got.device))

        torch.cuda.synchronize()
        t0 = time.monotonic()
        for op in COLLECTIVE_OPS:
            check(f"allreduce_{op}", col.allreduce(x[0], op=op,
                                                   group_name=group),
                  functools.reduce(npop[op], [a[0] for a in xs]))
            check(f"reducescatter_{op}", col.reducescatter(
                x[:world], op=op, group_name=group),
                functools.reduce(npop[op], [a[rank] for a in xs]))
        check("reduce", col.reduce(x[1], dst_rank=1, group_name=group),
              xs[0][1] + xs[1][1] if rank == 1 else xs[rank][1])
        check("broadcast", col.broadcast(x[2], src_rank=1, group_name=group),
              xs[1][2])
        check("allgather", col.allgather(x[3], group_name=group),
              np.stack([a[3] for a in xs]))
        check("permute", col.permute(x[0], [(0, 1), (1, 0)],
                                     group_name=group), xs[1 - rank][0])
        col.barrier(group_name=group)
        if rank == 0:
            col.send(x[1], dst_rank=1, group_name=group)
        else:  # a tensor arrives on the CPU, in its own dtype
            check("send_recv", col.recv(src_rank=0, group_name=group),
                  xs[0][1], device="cpu")
        col.barrier(group_name=group)
        torch.cuda.synchronize()
        ops_s = time.monotonic() - t0
        unchanged = bool(torch.equal(x, keep))

        ch = DeviceChannel(group, src_rank=0, dst_rank=1,
                           shape=COLLECTIVE_CHANNEL_SHAPE,
                           dtype=torch.bfloat16, device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 50)
        transfers = []
        for _ in range(COLLECTIVE_CHANNEL_SENDS):
            payload = torch.randn(COLLECTIVE_CHANNEL_SHAPE, generator=g,
                                  device=dev).to(torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if rank == 0:
                ch.write(payload)
                ok = True
            else:
                got = ch.read()
                ok = got.device.type == "cuda" and bool(torch.equal(
                    got, payload))
            torch.cuda.synchronize()
            transfers.append((ok, time.monotonic() - t0))
        col.destroy_collective_group(group)
        return dict(rank=rank, pid=os.getpid(), init_s=init_s, ops_s=ops_s,
                    checks=checks, unchanged=unchanged, transfers=transfers,
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"))


class _NcclMember:
    """A num_gpus=1 actor: reads the driver's tensor host-staged, and runs
    a one-rank NCCL group (one card cannot hold two NCCL ranks)."""

    def read(self, refs):
        return _runtime_read_tensor(refs)

    def nccl(self, group):
        import torch

        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective.collective import _manager

        dev = torch.device("cuda", 0)
        t0 = time.monotonic()
        col.init_collective_group(1, 0, backend="nccl", group_name=group)
        init_s = time.monotonic() - t0
        grp = _manager.get(group)
        t = torch.arange(1 << 20, dtype=torch.float32, device=dev)
        w = t.clone()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        grp._backend_allreduce(w)    # through ProcessGroupNCCL itself
        torch.cuda.synchronize()
        allreduce_s = time.monotonic() - t0
        out = dict(
            pg=type(grp.pg).__name__, device=str(grp.device),
            init_s=init_s, allreduce_s=allreduce_s,
            equal=bool(torch.equal(w, t)), result_device=str(w.device),
            # at world 1 the API hands back its input, as the JAX package's
            world_one_is_input=col.allreduce(t, group_name=group) is t,
            nccl_version=".".join(map(str, torch.cuda.nccl.version())))
        col.destroy_collective_group(group)
        return out


def _collective_whoami():
    return (os.environ.get("RT_NODE_ID"),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


def _collective_train_fn(config):
    """A numpy train fn: least squares by gradient steps, a report each."""
    import numpy as np

    from ray_tpu_torch import train

    rng = np.random.default_rng(config["seed"])
    a = rng.standard_normal((256, 16))
    b = a @ rng.standard_normal(16)
    w = np.zeros(16)
    for step in range(1, config["steps"] + 1):
        r = a @ w - b
        w -= 0.5 * a.T @ r / len(b)
        train.report({"step": step, "loss": float(r @ r / len(b)),
                      "node": os.environ.get("RT_NODE_ID"),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def _h2d_copies(prof) -> int:
    """Host-to-device memcpys a profile saw on the device."""
    return sum(1 for e in prof.events() if "HtoD" in e.name)


def _allocated_bytes(dev) -> int:
    """Bytes this process has allocated on ``dev`` so far (a cumulative
    counter: a get that copies onto the card allocates the copy)."""
    import torch

    return torch.cuda.memory_stats(dev).get("allocated_bytes.all.allocated",
                                            0)


def phase_collective(dev):
    """The device object plane and the collective groups on the card (see
    the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental.rdt import device_object_manager
    from ray_tpu_torch.gpu.slice import slice_placement_group
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    t_phase = time.monotonic()
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_collective_")
    os.environ["RT_GPU_AUTODETECT"] = "1"
    rt.init(num_cpus=COLLECTIVE_CPUS, system_config={
        "object_store_memory_bytes": COLLECTIVE_STORE_BYTES})
    from ray_tpu_torch._private.worker import global_context

    system_pids = [p.pid for p in global_context().owned_processes]
    session_dir = global_context().session_dir
    try:
        # rdt: the driver's put and get of a 256 MiB bf16 CUDA tensor
        g = torch.Generator(device=dev).manual_seed(SEED + 30)
        x = torch.randn(COLLECTIVE_TENSOR_SHAPE, device=dev,
                        generator=g).to(torch.bfloat16)
        nbytes = x.numel() * x.element_size()
        put_sums = _tensor_checksums(x)
        stats = device_object_manager().stats
        before = dict(stats)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ref = rt.put(x)
        put_s = time.monotonic() - t0
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        alloc = _allocated_bytes(dev)
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            y = rt.get(ref, timeout=120)
            torch.cuda.synchronize()
            hit_s = time.monotonic() - t0
        hit = dict(same=y is x, h2d=_h2d_copies(prof),
                   allocated=_allocated_bytes(dev) - alloc,
                   hits=stats["device_hits"] - before["device_hits"])
        del y
        x.add_(1)   # written after the put: a get must not return it
        before = dict(stats)
        alloc = _allocated_bytes(dev)
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            z = rt.get(ref, timeout=120)
            torch.cuda.synchronize()
            rebuild_s = time.monotonic() - t0
        rebuild = dict(same=z is x, device=str(z.device), h2d=_h2d_copies(prof),
                       allocated=_allocated_bytes(dev) - alloc,
                       put_time_values=_tensor_checksums(z) == put_sums,
                       rebuilds=stats["host_rebuilds"]
                       - before["host_rebuilds"])
        del z
        nccl_actor = rt.remote(num_gpus=1, num_cpus=1)(_NcclMember).remote()
        task = rt.get(nccl_actor.read.remote([ref]), timeout=300)
        del x, ref
        torch.cuda.empty_cache()
        out["rdt"] = dict(
            nbytes=nbytes, put_s=put_s, put_gbps=nbytes / put_s / 1e9,
            hit_get_ms=1e3 * hit_s, hit=hit,
            rebuild_get_s=rebuild_s, rebuild_gbps=nbytes / rebuild_s / 1e9,
            rebuild=rebuild, task_get_s=task["get_s"],
            task_gbps=nbytes / task["get_s"] / 1e9,
            task_checksums_equal=task["checksums"] == put_sums,
            task_device=task["device"])
        print(f"collective: rdt get in the putting process "
              f"{out['rdt']['hit_get_ms']:.4f} ms (the tensor itself, "
              f"{hit['h2d']} host-to-device copies) against host-staged "
              f"{rebuild_s:.3f} s after add_ ({out['rdt']['rebuild_gbps']:.2f} "
              f"GB/s, {rebuild['h2d']} copies) and {task['get_s']:.3f} s in a "
              f"num_gpus=1 actor ({out['rdt']['task_gbps']:.2f} GB/s); put "
              f"{put_s:.3f} s ({out['rdt']['put_gbps']:.2f} GB/s)", flush=True)

        # a one-rank NCCL group in the num_gpus=1 actor
        out["nccl"] = rt.get(nccl_actor.nccl.remote("chip-nccl"), timeout=300)
        rt.kill(nccl_actor)
        print(f"collective: NCCL {out['nccl']['nccl_version']}: "
              f"{out['nccl']['pg']} on {out['nccl']['device']}, made in "
              f"{out['nccl']['init_s']:.3f} s, one all-reduce "
              f"{1e3 * out['nccl']['allreduce_s']:.2f} ms", flush=True)

        # gloo across two num_gpus=0.5 actors carrying CUDA tensors
        member = rt.remote(num_gpus=0.5, num_cpus=1)(_GlooMember)
        t0 = time.monotonic()
        # (they wait for the NCCL actor's lease to return)
        members = [member.remote(r) for r in range(COLLECTIVE_WORLD)]
        gloo = rt.get([m.run.remote("chip-gloo") for m in members],
                      timeout=300)
        out["gloo"] = dict(wall_s=time.monotonic() - t0, ranks=gloo)
        for m in members:
            rt.kill(m)
        ms = [1e3 * s for r in gloo if r["rank"] == 1
              for _, s in r["transfers"]]
        print(f"collective: gloo pair up and through every op in "
              f"{out['gloo']['wall_s']:.2f} s (ops "
              f"{max(r['ops_s'] for r in gloo):.3f} s); DeviceChannel "
              f"{COLLECTIVE_CHANNEL_SHAPE} bf16 transfers "
              f"{[round(v, 2) for v in ms]} ms", flush=True)

        # gang placement: the card's own node as an NVLink domain
        nodes = [n for n in rt.nodes() if n["state"] == "ALIVE"]
        labels = nodes[0]["labels"]
        pod, topo = labels["gpu-pod-type"], labels["gpu-topology"]
        spg = slice_placement_group(pod, topology=topo)
        ready = spg.ready(timeout=120)
        dispatched = rt.get(spg.dispatch(_collective_whoami), timeout=120)
        spg.remove()
        result = TorchTrainer(
            _collective_train_fn, train_loop_config={"seed": SEED, "steps": 5},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                         topology=topo, accelerator_type=pod),
            run_config=RunConfig(name="gang", storage_path=tmp)).fit()
        hist = [m for m in result.metrics_history if "loss" in m]
        out["gang"] = dict(
            pod_type=pod, topology=topo, node=nodes[0]["node_id"],
            domain=labels.get("gpu-domain-name"), ready=ready,
            dispatched=dispatched, losses=[m["loss"] for m in hist],
            train_nodes=sorted({m["node"] for m in hist}),
            train_visible=sorted({str(m["visible"]) for m in hist}))
        print(f"collective: gang {pod} {topo} on {out['gang']['domain']}: "
              f"dispatch {dispatched}; trainer nodes "
              f"{out['gang']['train_nodes']}", flush=True)
    finally:
        rt.shutdown()
        os.environ.pop("RT_GPU_AUTODETECT", None)
        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.monotonic() + 30
    while (_cluster_pids(session_dir, system_pids)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    left = _cluster_pids(session_dir, system_pids)
    out["left_after_shutdown"] = left
    out["phase_s"] = time.monotonic() - t_phase
    print(json.dumps({"collective": out}), flush=True)
    print(f"collective: phase {out['phase_s']:.1f} s", flush=True)

    r = out["rdt"]
    # the hit: no host-to-device memcpy under the profiler and not a byte
    # allocated on the card; the rebuild is the control: it allocates its
    # copy (the profiler sees its memcpy when it traces the device: the
    # phase alone, yes; after the data phase's profiled step, no)
    _check(r["hit"]["same"] and r["hit"]["hits"] == 1
           and r["hit"]["h2d"] == 0 and r["hit"]["allocated"] == 0,
           f"collective: the putting process's get was not the tensor "
           f"itself with no copy: {r['hit']}")
    _check(not r["rebuild"]["same"] and r["rebuild"]["rebuilds"] == 1
           and r["rebuild"]["put_time_values"]
           and r["rebuild"]["allocated"] >= r["nbytes"]
           and r["rebuild"]["device"].startswith("cuda"),
           f"collective: after add_ the get was not a host rebuild of the "
           f"put-time values onto the card: {r['rebuild']}")
    _check(r["task_checksums_equal"] and r["task_device"].startswith("cuda"),
           f"collective: the num_gpus=1 actor read other values or off the "
           f"card: {r['task_device']}")
    n = out["nccl"]
    _check(n["pg"] == "ProcessGroupNCCL" and n["equal"]
           and n["result_device"].startswith("cuda")
           and n["world_one_is_input"],
           f"collective: the one-rank NCCL group: {n}")
    for rank in out["gloo"]["ranks"]:
        bad = {k: v for k, v in rank["checks"].items() if not v[0]}
        _check(not bad and rank["unchanged"],
               f"collective: gloo rank {rank['rank']}: ops off their numpy "
               f"twin or off the card {bad}, input unchanged "
               f"{rank['unchanged']}")
        _check(len(rank["checks"]) == 12 + rank["rank"]
               and all(ok for ok, _ in rank["transfers"]),
               f"collective: gloo rank {rank['rank']}: checks "
               f"{sorted(rank['checks'])}, transfers {rank['transfers']}")
    gang = out["gang"]
    _check(gang["ready"] and [d[0] for d in gang["dispatched"]]
           == [gang["node"]] and gang["train_nodes"] == [gang["node"]],
           f"collective: gang placement: {gang}")
    _check(len(gang["losses"]) == 5
           and gang["losses"][-1] < gang["losses"][0],
           f"collective: the gang's train fn: losses {gang['losses']}")
    _check(not left, f"collective: processes left after shutdown: {left}")
    return out


OPS_CPUS = 4               # each of the two daemons
# the flagship at the trainer phase's depth cut (4 of 16 layers, full
# width): K1/K2/K3 8/4/4 a step
OPS_CFG = TRAINER_CFG
OPS_LRS = (TRAIN_LR, 3e-4, 1e-3)   # the tune trials' learning rates
OPS_TUNE_STEPS = 6         # ASHA's max_t: rungs at steps 1, 2 and 4
OPS_TUNE_PAUSE_S = 0.3     # after each report: time for a stop to land
OPS_PREEMPT_STEPS = 6
OPS_CKPT_EVERY = 2         # the preempted run checkpoints every 2 steps
OPS_NOTICE_AFTER = 2       # its first attempt is noticed after this step
OPS_NOTICE_DEADLINE_MS = 6000
OPS_WAIT_PREEMPT_S = 120   # the first attempt's wait to be preempted
OPS_CAPTURE_S = 3.0
# a custom resource only the head advertises: the tune trials ask for half
# of it beside half a GPU, so they run on the head's card
OPS_HEAD_RESOURCE = "ops_head"
OPS_TRAINER_GPU = 0.5      # the preempted trainer's worker: half a card
# each kernel's symbol in the trace (K1: hopper_attn.cuh's attn_fwd, which
# flash_fwd.cu launches; K4, not on this path, is its CARRY instance)
OPS_KERNEL_SYMBOLS = (("k1", "attn_fwd"), ("k2", "flash_bwd_dq_kernel"),
                      ("k3", "flash_bwd_dkv_kernel"))


def _ops_counts():
    """The K1/K2/K3 launch counters of this process, then zeroed."""
    from ray_tpu_torch.ops import flash_attention as fa

    out = dict(k1=fa.flash_fwd_launches, k2=fa.flash_bwd_dq_launches,
               k3=fa.flash_bwd_dkv_launches)
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    return out


def _ops_model(cfg, lr, remat, seed, dev):
    """The flagship's ``make_train_step`` at ``cfg`` ("flash") on ``dev``:
    (state from ``seed``, train_step, data device)."""
    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step

    init_state, shard_state, train_step, data_dev = make_train_step(
        LlamaConfig(**cfg, attention_impl="flash"), learning_rate=lr,
        remat=remat, loss_chunk=0, device=dev)
    return shard_state(init_state(seed)), train_step, data_dev


def _ops_reference(dev):
    """Each OPS_LRS learning rate's losses in this process, from the seed on
    the train batch: OPS_PREEMPT_STEPS steps at TRAIN_LR, OPS_TUNE_STEPS at
    the others."""
    import torch

    out = {}
    for lr in OPS_LRS:
        state, train_step, data_dev = _ops_model(OPS_CFG, lr, TRAIN_REMAT,
                                                 SEED, dev)
        tokens = _train_tokens(data_dev)
        steps = OPS_PREEMPT_STEPS if lr == TRAIN_LR else OPS_TUNE_STEPS
        losses = []
        for _ in range(max(steps, OPS_TUNE_STEPS)):
            state, loss = train_step(state, tokens)
            losses.append(float(loss))
        out[lr] = losses
        del state
    torch.cuda.empty_cache()
    return out


class _OpsProfiled:
    """A num_gpus=1 actor holding the flagship after one warm-up step: it
    serves ``gpu/profiler.py`` captures of its own process, and takes one
    step once a capture is recording."""

    def __init__(self, config):
        import torch

        self.dev = torch.device("cuda", 0)
        self.state, self.train_step, data_dev = _ops_model(
            config["cfg"], config["lr"], config["remat"], config["seed"],
            self.dev)
        self.tokens = torch.from_numpy(config["tokens"]).to(data_dev)
        self.state, _ = self.train_step(self.state, self.tokens)
        torch.cuda.synchronize()

    def listen(self):
        from ray_tpu_torch.gpu import profiler

        return profiler.init_profiler(0), os.environ["RT_NODE_ID"], os.getpid()

    def step_when_profiled(self, timeout):
        import torch

        from ray_tpu_torch.gpu import profiler

        deadline = time.monotonic() + timeout
        while not profiler.capturing():
            if time.monotonic() > deadline:
                raise TimeoutError("no capture began")
            time.sleep(0.01)
        _ops_counts()
        t = time.monotonic()
        self.state, loss = self.train_step(self.state, self.tokens)
        loss = float(loss)
        torch.cuda.synchronize()
        return dict(loss=loss, ms=1e3 * (time.monotonic() - t),
                    launches=_ops_counts(), capturing=profiler.capturing())


def _ops_trial(config):
    """The tune trainable, in a trial actor on half of a card: the flagship
    from the seed at ``config["lr"]``, a report after each step."""
    import torch

    from ray_tpu_torch import tune

    state, train_step, data_dev = _ops_model(
        config["cfg"], config["lr"], config["remat"], config["seed"],
        torch.device("cuda", 0))
    tokens = torch.from_numpy(config["tokens"]).to(data_dev)
    _ops_counts()
    for _ in range(config["steps"]):
        state, loss = train_step(state, tokens)
        tune.report({"loss": float(loss), "launches": _ops_counts(),
                     "pid": os.getpid(),
                     "device": torch.cuda.get_device_name(0)})
        time.sleep(config["pause_s"])


def _ops_job_main(lr):
    """The GPU job's entrypoint (``chip_smoke.py --ops-job LR``): joins the
    cluster at RT_ADDRESS, takes one flagship step on the card and prints
    the card's name and the loss."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import ray_tpu_torch as rt

    rt.init(address=os.environ["RT_ADDRESS"])
    try:
        dev = torch.device("cuda", 0)
        state, train_step, data_dev = _ops_model(OPS_CFG, lr, TRAIN_REMAT,
                                                 SEED, dev)
        _ops_counts()
        _, loss = train_step(state, _train_tokens(data_dev))
        print(json.dumps({"ops_job": dict(
            device_name=torch.cuda.get_device_name(dev), loss=float(loss),
            launches=_ops_counts(), gpus=rt.cluster_resources().get("GPU"))}),
            flush=True)
    finally:
        rt.shutdown()
    return 0


def _ops_preempt_fn(config):
    """The preempted trainer's train fn, in a num_gpus=1 train worker: the
    flagship from the seed, restored from the run's latest checkpoint, a
    report after each step, the train state every ``ckpt_every``. The first
    attempt, once step ``notice_after``'s checkpoint is final and the
    controller holds every report, marks it and waits for its node's
    drain to end it."""
    import torch

    from ray_tpu_torch import train

    dev = train.setup_torch_distributed()
    ctx = train.get_context()
    (params, opt), train_step, data_dev = _ops_model(
        config["cfg"], config["lr"], config["remat"], config["seed"], dev)
    start, restored = 1, None
    ckpt = ctx.get_checkpoint()
    if ckpt is not None:
        tree = ckpt.load_state(train.train_state_tree(params, opt))
        train.load_train_state(tree, params, opt)
        start, restored = ckpt.step + 1, ckpt.step
    tokens = torch.from_numpy(config["tokens"]).to(data_dev)
    _ops_counts()
    for step in range(start, config["steps"] + 1):
        (params, opt), loss = train_step((params, opt), tokens)
        metrics = dict(step=step, loss=float(loss), restored=restored,
                       node=os.environ.get("RT_NODE_ID"),
                       device=torch.cuda.get_device_name(dev),
                       launches=_ops_counts(), t_step_end=time.time())
        if step % config["ckpt_every"] == 0:
            train.report(metrics, checkpoint_state=train.train_state_tree(
                params, opt))
        else:
            train.report(metrics)
        if step == config["notice_after"] and restored is None:
            final = os.path.join(config["run_dir"], "checkpoint_%09d" % step)
            deadline = time.time() + 300
            while time.time() < deadline and not (
                    os.path.isdir(final) and ctx.report_queue.empty()):
                time.sleep(0.05)
            with open(config["marker"], "w") as f:
                f.write(os.environ.get("RT_NODE_ID", ""))
            time.sleep(config["wait_s"])
            raise RuntimeError(
                f"no preemption ended this worker in {config['wait_s']} s")


def _ops_trace_kernels(files):
    """K1/K2/K3 events in the chrome traces ``files``: each kernel's count
    and summed device ms."""
    counts = {k: 0 for k, _ in OPS_KERNEL_SYMBOLS}
    ms = {k: 0.0 for k, _ in OPS_KERNEL_SYMBOLS}
    kernels = 0
    for path in files:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") != "kernel":
                continue
            kernels += 1
            for key, sym in OPS_KERNEL_SYMBOLS:
                if sym in e.get("name", ""):
                    counts[key] += 1
                    ms[key] += e.get("dur", 0.0) / 1e3
    return dict(counts=counts, ms=ms, kernels=kernels)


def _ops_nodes(cw):
    reply = cw.run_sync(cw.control.call("get_all_nodes", {}), 10)
    return {n["node_id"].hex(): n for n in reply["nodes"]}


def _ops_profile(rt, out, actor, card):
    """profile: ``capture_on_node`` of a num_gpus=1 actor's process through
    its ``init_profiler`` listener while the actor takes one step."""
    from ray_tpu_torch.gpu.profiler import capture_on_node

    try:
        port, node, pid = rt.get(actor.listen.remote(), timeout=300)
        step = actor.step_when_profiled.remote(OPS_CAPTURE_S)
        t = time.monotonic()
        files = capture_on_node(node, None, duration_s=OPS_CAPTURE_S,
                                port=port)
        capture_s = time.monotonic() - t
        stepped = rt.get(step, timeout=60)
    finally:
        rt.kill(actor)
    traced = _ops_trace_kernels(files)
    for path in files:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    out["profile"] = dict(files=files, pid=pid, node=node,
                          capture_s=capture_s, step=stepped, trace=traced)
    print(f"ops profile: K1/K2/K3 {traced['counts']} in the trace of pid "
          f"{pid}, {stepped['launches']} by the counters; device ms "
          f"{ {k: round(v, 3) for k, v in traced['ms'].items()} } "
          f"({sum(traced['ms'].values()):.3f} summed) on {card}",
          flush=True)
    _check(traced["counts"] == stepped["launches"] == _ops_step_launches()
           and stepped["capturing"],
           f"ops profile: the trace holds K1/K2/K3 {traced['counts']}, the "
           f"counters read {stepped['launches']}")
    return stepped["launches"]


def _ops_step_launches():
    """K1/K2/K3 of one step of OPS_CFG: K1 twice a layer (remat "dots")."""
    n = OPS_CFG["n_layers"]
    return dict(k1=2 * n, k2=n, k3=n)


def _ops_tune(rt, out, config, reference):
    """tune: ASHA over OPS_LRS, each trial on half of the head's card."""
    from ray_tpu_torch import tune

    # the trials run two at a time, in the order of their loss after two
    # steps (lowest first), so the last, the worst, meets a full rung
    order = sorted(OPS_LRS, key=lambda lr: reference[lr][1])
    sched = tune.ASHAScheduler(max_t=OPS_TUNE_STEPS, grace_period=1,
                               reduction_factor=2)
    t = time.monotonic()
    results = tune.Tuner(
        _ops_trial,
        param_space=dict(config, lr=tune.grid_search(order),
                         steps=OPS_TUNE_STEPS, pause_s=OPS_TUNE_PAUSE_S),
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=sched,
                                    max_concurrent_trials=2),
        trial_resources={"GPU": 0.5, OPS_HEAD_RESOURCE: 0.5},
    ).fit(timeout=600)
    fit_s = time.monotonic() - t
    trials = [dict(lr=r.config["lr"], status=r.status, error=r.error,
                   losses=[m["loss"] for m in r.history],
                   pids=sorted({m["pid"] for m in r.history}),
                   devices=sorted({m["device"] for m in r.history}),
                   launches=[m["launches"] for m in r.history])
              for r in results]
    best = results.get_best_result()
    lowest = min(results, key=lambda r: r.metrics["loss"])
    out["tune"] = dict(order=list(order), fit_s=fit_s, trials=trials,
                       best_lr=best.config["lr"],
                       lowest_lr=lowest.config["lr"],
                       best_is_lowest=best.trial_id == lowest.trial_id)
    print(f"ops tune: "
          f"{[(x['lr'], x['status'], len(x['losses'])) for x in trials]}"
          f" in {fit_s:.2f} s; best lr {best.config['lr']}", flush=True)
    for x in trials:
        _check(x["status"] in ("TERMINATED", "STOPPED") and not x["error"],
               f"ops tune: trial at lr {x['lr']} {x['status']}: {x['error']}")
        for i, loss in enumerate(x["losses"]):
            _check(abs(loss - reference[x["lr"]][i]) <= TOL_TRAINER_LOSS,
                   f"ops tune: lr {x['lr']} step {i + 1} loss {loss} "
                   f"against {reference[x['lr']][i]} in process")
        _check(all(la == _ops_step_launches() for la in x["launches"]),
               f"ops tune: lr {x['lr']} launched {x['launches']}")
    _check(any(x["status"] == "STOPPED" for x in trials),
           f"ops tune: ASHA stopped no trial: {trials}")
    _check(out["tune"]["best_is_lowest"] and best.config["lr"] == order[0],
           f"ops tune: best lr {best.config['lr']}, lowest loss at "
           f"{lowest.config['lr']}, reference best {order[0]}")
    return {k: sum(la[k] for x in trials for la in x["launches"])
            for k in ("k1", "k2", "k3")}


def _ops_wait_gpus(rt, want, timeout=60.0):
    """The cluster's available GPUs, once they read ``want`` (or at the
    timeout)."""
    deadline = time.monotonic() + timeout
    while (rt.available_resources().get("GPU", 0.0) != want
           and time.monotonic() < deadline):
        time.sleep(0.1)
    return rt.available_resources().get("GPU", 0.0)


def _ops_job_wait(client, sid, want, timeout):
    deadline = time.monotonic() + timeout
    st = client.get_job_status(sid)
    while st not in want and time.monotonic() < deadline:
        time.sleep(0.2)
        st = client.get_job_status(sid)
    return st


def _ops_gpu_job(client, out, sid, t, reference):
    """jobs: the GPU job submitted at ``t``, which joins the cluster and
    takes one step, SUCCEEDS with the card's name and the in-process loss
    in its logs."""
    status = _ops_job_wait(client, sid, ("SUCCEEDED", "FAILED", "STOPPED"),
                           300)
    job_s = time.monotonic() - t
    logs = client.get_job_logs(sid)
    rows = [json.loads(ln)["ops_job"] for ln in logs.splitlines()
            if ln.startswith('{"ops_job"')]
    _check(status == "SUCCEEDED" and len(rows) == 1,
           f"ops jobs: the GPU job {status}: {logs[-2000:]}")
    job = rows[0]
    out["jobs"] = dict(job_s=job_s, job=job,
                       node=client.get_job_info(sid).get("supervisor_node"))
    print(f"ops jobs: {job['device_name']} loss {job['loss']} in "
          f"{job_s:.2f} s", flush=True)
    _check(job["device_name"] in logs and abs(
        job["loss"] - reference[TRAIN_LR][0]) <= TOL_TRAINER_LOSS,
        f"ops jobs: the job's loss {job['loss']} against "
        f"{reference[TRAIN_LR][0]} in process")
    _check(job["launches"] == _ops_step_launches(),
           f"ops jobs: the job's step launched {job['launches']}")
    return job["launches"]


def _ops_loop_job(rt, client, out, before):
    """jobs: a looping GPU job stopped; the GPU it held returns."""
    loop = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time\nwhile True: "
                   f"time.sleep(0.1)\"", resources={"GPU": 1})
    running = _ops_job_wait(client, loop, ("RUNNING",), 120)
    held = _ops_wait_gpus(rt, before - 1.0)
    t = time.monotonic()
    client.stop_job(loop)
    stopped = _ops_job_wait(client, loop, ("STOPPED", "SUCCEEDED", "FAILED"),
                            120)
    after = _ops_wait_gpus(rt, before)
    stop_s = time.monotonic() - t
    out["jobs"].update(loop_status=[running, stopped],
                       gpus=[before, held, after], stop_s=stop_s)
    print(f"ops jobs: the looping job {running} then {stopped} in "
          f"{stop_s:.2f} s, GPU {before} -> {held} -> {after}", flush=True)
    _check(running == "RUNNING" and stopped == "STOPPED" and held == before - 1
           and after == before,
           f"ops jobs: looping job {running} -> {stopped}, GPU {before} -> "
           f"{held} -> {after}")


def _ops_preempt_start(config, tmp):
    """preempt: the fit of a TorchTrainer with one half-card worker, on a
    thread. Returns its controller, thread, result box and train
    config."""
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, TorchTrainer)

    cfg = dict(config, lr=TRAIN_LR, steps=OPS_PREEMPT_STEPS,
               ckpt_every=OPS_CKPT_EVERY, notice_after=OPS_NOTICE_AFTER,
               wait_s=OPS_WAIT_PREEMPT_S, marker=os.path.join(tmp, "noticed"),
               run_dir=os.path.join(tmp, "preempt"))
    # half a card: the resumed worker shares the head's with the last
    # tune trial
    trainer = TorchTrainer(
        _ops_preempt_fn, train_loop_config=cfg,
        scaling_config=ScalingConfig(
            num_workers=1, use_gpu=True,
            resources_per_worker={"GPU": OPS_TRAINER_GPU}),
        run_config=RunConfig(
            name="preempt", storage_path=tmp,
            failure_config=FailureConfig(max_failures=0),
            checkpoint_config=CheckpointConfig(num_to_keep=2)))
    ctrl = trainer._controller()
    box = {}
    fit = threading.Thread(target=lambda: box.update(result=ctrl.run()),
                           daemon=True)
    fit.start()
    return ctrl, fit, box, cfg


def _ops_preempt(rt, out, cluster, run, reference):
    """preempt: once the first attempt (on the spot node) has marked its
    step-2 checkpoint, a wave aimed at the spot daemon through
    ``chaos_set``; the run resumes on the head's card."""
    from ray_tpu_torch.runtime.rpc import RpcClient

    ctrl, fit, box, cfg = run
    head, spot = cluster.nodes[0], cluster.nodes[1]
    cw = rt.get_core_worker()
    deadline = time.monotonic() + 300
    while not os.path.exists(cfg["marker"]) and fit.is_alive():
        _check(time.monotonic() < deadline,
               "ops preempt: the first attempt never reached its notice")
        time.sleep(0.05)
    _check(os.path.exists(cfg["marker"]),
           f"ops preempt: the run ended before its notice: {box}")
    with open(cfg["marker"]) as f:
        first_node = f.read()

    async def aim():
        c = RpcClient(spot.address, name="chip_smoke->spot")
        try:
            return await c.call("chaos_set", {"config": {
                "testing_preempt_wave":
                    f"1.0:0:{OPS_NOTICE_DEADLINE_MS}"}}, timeout=30)
        finally:
            await c.close()

    t_notice = time.time()
    aimed = cw.run_sync(aim(), timeout=30)
    seen = {}  # each state of the spot node: (s after the notice, reason)
    while "DEAD" not in seen and time.time() < t_notice + 60:
        rec = _ops_nodes(cw).get(spot.node_id)
        if rec is not None and rec["state"] not in seen:
            seen[rec["state"]] = (time.time() - t_notice,
                                  rec.get("drain_reason", ""))
            seen["death"] = rec.get("death")
        time.sleep(0.05)
    fit.join(300)
    _check(not fit.is_alive(), "ops preempt: fit did not return")
    result = box["result"]
    hist = [m for m in result.metrics_history if "loss" in m]
    first = [m for m in hist if m["restored"] is None]
    second = [m for m in hist if m["restored"] is not None]
    out["preempt"] = dict(
        error=result.error, aimed=aimed, states=seen,
        first_node=first_node, spot=spot.node_id, head=head.node_id,
        steps_first=[m["step"] for m in first],
        steps_second=[m["step"] for m in second],
        restored=sorted({m["restored"] for m in second}),
        nodes_second=sorted({m["node"] for m in second}),
        devices=sorted({m["device"] for m in hist}),
        losses=[m["loss"] for m in hist],
        drain_rejoins=ctrl.drain_rejoins, failures=ctrl.failure_count,
        notice_to_preempting_s=seen.get("PREEMPTING", (None,))[0],
        # the drain ends with the node's expected death "drained (...)"
        notice_to_drained_s=seen.get("DEAD", (None,))[0],
        notice_to_resumed_step_s=(second[0]["t_step_end"] - t_notice
                                  if second else None))
    p = out["preempt"]
    print(f"ops preempt: notice to PREEMPTING "
          f"{p['notice_to_preempting_s']} s, to DRAINING "
          f"{seen.get('DRAINING', (None,))[0]} s, to drained (DEAD) "
          f"{p['notice_to_drained_s']} s, to the resumed step "
          f"{p['notice_to_resumed_step_s']} s; steps "
          f"{p['steps_first']} on the spot node, {p['steps_second']} on "
          f"the head; rejoins {p['drain_rejoins']}, failures "
          f"{p['failures']}", flush=True)
    death = seen.get("death") or {}
    _check(result.error is None, f"ops preempt: fit failed: {result.error}")
    _check(first_node == spot.node_id and p["nodes_second"] == [head.node_id],
           f"ops preempt: first attempt on {first_node}, resumed on "
           f"{p['nodes_second']} (spot {spot.node_id}, head {head.node_id})")
    _check(seen.get("PREEMPTING", (0, ""))[1] == "preemption"
           and death.get("expected") is True
           and death.get("reason") == "drained (preemption)",
           f"ops preempt: the spot node went {seen}")
    _check(p["drain_rejoins"] == 1 and p["failures"] == 0,
           f"ops preempt: {p['drain_rejoins']} planned rejoins, "
           f"{p['failures']} failures")
    _check(p["steps_first"] == list(range(1, OPS_NOTICE_AFTER + 1))
           and p["restored"] == [OPS_NOTICE_AFTER]
           and p["steps_second"] == list(range(OPS_NOTICE_AFTER + 1,
                                               OPS_PREEMPT_STEPS + 1)),
           f"ops preempt: steps {p['steps_first']} then "
           f"{p['steps_second']} from {p['restored']}")
    for m in hist:
        _check(abs(m["loss"] - reference[TRAIN_LR][m["step"] - 1])
               <= TOL_TRAINER_LOSS,
               f"ops preempt: step {m['step']} loss {m['loss']} against "
               f"{reference[TRAIN_LR][m['step'] - 1]} uninterrupted")
        _check(m["launches"] == _ops_step_launches(),
               f"ops preempt: step {m['step']} launched {m['launches']}")
    return {k: sum(m["launches"][k] for m in hist) for k in ("k1", "k2", "k3")}


def phase_ops(dev, card=""):
    """The preemption watcher, the profiler, tune and job submission on
    one two-node cluster (see the module docstring). The parts overlap
    where the cards allow: the profiled actor (on the spot node's card)
    and the GPU job (the head's: job supervisors stay off spot capacity)
    start while this process computes the references; the tune trials
    (half of the head's card each, through OPS_HEAD_RESOURCE) run beside
    the preempted trainer, whose half-card worker starts on the spot
    node's card and resumes on the head's beside the last trial."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.protocol import SchedulingStrategy
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.job_submission import JobSubmissionClient

    t_phase = time.monotonic()
    out = {"config": dict(OPS_CFG, attention_impl="flash", remat=TRAIN_REMAT,
                          batch=TRAIN_BATCH, seq=TRAIN_SEQ, lrs=OPS_LRS)}
    config = dict(cfg=OPS_CFG, lr=TRAIN_LR, remat=TRAIN_REMAT, seed=SEED,
                  tokens=_train_tokens_np())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_")
    t = time.monotonic()
    cluster = Cluster(head_resources={"CPU": OPS_CPUS, "GPU": 1,
                                      OPS_HEAD_RESOURCE: 1})
    spot = cluster.add_node(resources={"CPU": OPS_CPUS, "GPU": 1},
                            labels={"spot": "true"})
    rt.init(address=cluster.address)
    out["cluster_start_s"] = time.monotonic() - t
    launches, stage_s = {}, {}
    try:
        # 1. the profiled actor (spot) and the GPU job (head) start while
        # the references run here
        t = time.monotonic()
        actor = rt.remote(num_gpus=1)(_OpsProfiled).options(
            scheduling_strategy=SchedulingStrategy(
                kind="NODE_AFFINITY", node_id=spot.node_id,
                soft=False)).remote(config)
        client = JobSubmissionClient()
        t_job = time.monotonic()
        sid = client.submit_job(
            entrypoint=f"{sys.executable} {os.path.abspath(__file__)} "
                       f"--ops-job {TRAIN_LR!r}", resources={"GPU": 1})
        t_ref = time.monotonic()
        reference = _ops_reference(dev)
        out["reference_s"] = time.monotonic() - t_ref
        out["reference"] = {repr(k): v for k, v in reference.items()}
        launches["profile"] = _ops_profile(rt, out, actor, card)
        launches["jobs"] = _ops_gpu_job(client, out, sid, t_job, reference)
        stage_s["profile_job_reference"] = time.monotonic() - t
        # 2. the looping job, while no other part holds a card
        t = time.monotonic()
        total = rt.cluster_resources().get("GPU", 0.0)
        _ops_loop_job(rt, client, out, _ops_wait_gpus(rt, total))
        stage_s["loop_job"] = time.monotonic() - t
        # 3. tune on the head's card beside the preempted trainer, which
        # starts on the spot node's once the first two trials hold the
        # head's; after the notice it resumes on the head's beside the
        # last trial
        t = time.monotonic()
        box = {}
        tuner = threading.Thread(target=lambda: box.update(
            tune=_ops_tune(rt, out, config, reference)), daemon=True)
        tuner.start()
        _check(_ops_wait_gpus(rt, total - 1.0) == total - 1.0,
               "ops: the tune trials never took the head's card")
        run = _ops_preempt_start(config, tmp)
        launches["preempt"] = _ops_preempt(rt, out, cluster, run, reference)
        tuner.join(600)
        _check(not tuner.is_alive() and "tune" in box,
               f"ops tune: the fit did not return ({box})")
        launches["tune"] = box["tune"]
        stage_s["tune_and_preempt"] = time.monotonic() - t
    finally:
        t = time.monotonic()
        rt.shutdown()
        # SIGTERM first: a daemon that stops ends its workers (they run in
        # sessions of their own, which a SIGKILL of the daemon's leaves)
        for node in list(cluster.nodes):
            cluster.kill_node(node, force=False)
        cluster.shutdown()
        GLOBAL_CONFIG.reset()
        chaos.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.monotonic() + 30
    while _cluster_pids(cluster.session_dir) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _cluster_pids(cluster.session_dir)
    stage_s["shutdown"] = time.monotonic() - t
    out["left_after_shutdown"] = left
    out["stage_s"] = stage_s
    out["launches_by_part"] = launches
    out["launches"] = {k: sum(v[k] for v in launches.values())
                       for k in ("k1", "k2", "k3")}
    out["phase_s"] = time.monotonic() - t_phase
    torch.cuda.empty_cache()
    print(json.dumps({"ops": out}, default=str), flush=True)
    print(f"ops: phase {out['phase_s']:.1f} s (cluster "
          f"{out['cluster_start_s']:.1f}, "
          + ", ".join(f"{k} {v:.1f}" for k, v in stage_s.items())
          + f"; reference {out['reference_s']:.1f} inside the first)",
          flush=True)
    _check(not left, f"ops: processes left after shutdown: {left}")
    return out


# the scale phase: the autoscaler brings the card in and takes it away
SCALE_CPUS = 4             # the head's; it has no GPU
SCALE_WORKER = {"CPU": 2.0, "GPU": 1.0}   # (a)'s worker type
SCALE_IDLE_S = 3.0         # idle this long: drained, then terminated
SCALE_POLL_S = 0.3
SCALE_DOMAIN = {"CPU": 2.0, "GPU": 1.0}   # (b)'s domain host
# (b)'s trainer: the trainer phase's cell (the flagship at 4 of 16 layers,
# full width): K1/K2/K3 8/4/4 a step
SCALE_CFG = TRAINER_CFG
SCALE_STEPS = 2
SCALE_WAIT_S = 120


def _scale_k1_task(shape, seed):
    """(a)'s num_gpus=1 task: the runtime phase's K1 call, with the node
    it ran on."""
    out = _runtime_k1_task(shape, seed)
    out["node_id"] = os.environ.get("RT_NODE_ID")
    return out


def _scale_train_fn(config):
    """(b)'s train fn, in the domain's train worker: the flagship from the
    seed, ``make_train_step`` steps on the train batch, a report after
    each."""
    import torch

    from ray_tpu_torch import train

    dev = train.setup_torch_distributed()
    t_cuda = time.time()
    state, train_step, data_dev = _ops_model(
        config["cfg"], config["lr"], config["remat"], config["seed"], dev)
    tokens = torch.from_numpy(config["tokens"]).to(data_dev)
    _ops_counts()
    for step in range(1, config["steps"] + 1):
        state, loss = train_step(state, tokens)
        train.report(dict(step=step, loss=float(loss),
                          node=os.environ.get("RT_NODE_ID"),
                          device=torch.cuda.get_device_name(dev),
                          launches=_ops_counts(), t_cuda=t_cuda,
                          t_step_end=time.time()))


def _scale_node(rt, node_id):
    return next((n for n in rt.nodes() if n["node_id"] == node_id), None)


def _scale_wait(pred, timeout, what):
    """Poll ``pred`` every 50 ms; its first truthy value."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        _check(time.monotonic() < deadline, f"scale: {what} in {timeout} s")
        time.sleep(0.05)


def _scale_worker(rt, addr, session_dir):
    """(a): a num_gpus=1 task on a head with no GPU; the autoscaler's
    ``SliceNodeProvider`` (``up``'s local provider) starts one GPU worker,
    the task runs K1 there, and once idle the worker is drained and
    terminated."""
    from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalingConfig,
                                          SliceNodeProvider)

    created = []

    class Counted(SliceNodeProvider):
        def create_node(self, resources):
            handle = super().create_node(resources)
            created.append(handle)
            return handle

    out = {}
    before = {n["node_id"] for n in rt.nodes()}
    scaler = Autoscaler(Counted(addr, session_dir), AutoscalingConfig(
        min_workers=0, max_workers=1, worker_resources=SCALE_WORKER,
        idle_timeout_s=SCALE_IDLE_S, poll_period_s=SCALE_POLL_S)).start()
    try:
        t0 = time.monotonic()
        ref = rt.remote(num_gpus=1)(_scale_k1_task).remote(K1_MAIN_SHAPE,
                                                           SEED)
        node = _scale_wait(lambda: next(
            (n for n in rt.nodes() if n["node_id"] not in before
             and n["state"] == "ALIVE"), None), SCALE_WAIT_S,
            "no worker came up for the GPU task")
        out["submit_to_alive_s"] = time.monotonic() - t0
        k1 = rt.get(ref, timeout=300)
        t_idle = time.monotonic()
        out["submit_to_result_s"] = t_idle - t0
        # the drain (the node id in the autoscaler's draining set) comes
        # before the termination empties the worker list
        drained = _scale_wait(
            lambda: list(scaler._draining) or (not scaler.workers and [None]),
            SCALE_WAIT_S, "the idle worker was not drained")
        out["idle_to_drain_s"] = time.monotonic() - t_idle
        _scale_wait(lambda: not scaler.workers, SCALE_WAIT_S,
                    "the drained worker was not terminated")
        out["idle_to_terminated_s"] = time.monotonic() - t_idle
        proc = created[0]["proc"] if created else None
        exited = proc is not None and _scale_wait(
            lambda: proc.poll() is not None, 30,
            "the worker's daemon did not exit")
        rec = _scale_wait(lambda: (lambda r: r if r and r["state"] == "DEAD"
                                   else None)(_scale_node(rt, node["node_id"])),
                          30, "the worker's node is not DEAD")
        # a poll or two more: nothing relaunches for the finished task
        time.sleep(3 * SCALE_POLL_S)
        out.update(creates=len(created), node=node["node_id"],
                   node_resources=node["resources"], k1_task=k1,
                   drained=drained == [node["node_id"]],
                   daemon_exited=bool(exited),
                   death=rec["death"],
                   launches=dict(k1=k1["launches"], k2=0, k3=0))
    finally:
        scaler.stop()
    print(json.dumps({"scale_worker": out}, default=str), flush=True)
    print(f"scale (a): submit to the worker ALIVE "
          f"{out['submit_to_alive_s']:.2f} s, to the task's result "
          f"{out['submit_to_result_s']:.2f} s; idle to drained "
          f"{out['idle_to_drain_s']:.2f} s, to terminated "
          f"{out['idle_to_terminated_s']:.2f} s (idle timeout "
          f"{SCALE_IDLE_S} s)", flush=True)
    _check(out["creates"] == 1, f"scale (a): {out['creates']} create_node")
    _check(k1["node_id"] == node["node_id"],
           f"scale (a): the task ran on {k1['node_id']}, the autoscaled "
           f"worker is {node['node_id']}")
    _check(k1["launches"] == 1 and k1["finite"] and k1["o_ok"]
           and k1["err_lse"] <= TOL_LSE, f"scale (a): K1 in the task: {k1}")
    _check(out["drained"] and out["daemon_exited"],
           f"scale (a): drained {out['drained']}, daemon exited "
           f"{out['daemon_exited']}")
    death = out["death"] or {}
    _check(death.get("expected") is True,
           f"scale (a): the worker's death record {death}")
    return out


def _scale_domain(rt, dev, addr, session_dir):
    """(b): a 1-worker ``TorchTrainer`` asking for an NVLink domain
    (``topology="1x1"``) on a cluster with none; the autoscaler's
    ``GpuVmNodeProvider`` on ``FakeGcpTransport`` provisions it, whose
    boot starts one daemon a host as a VM's startup script would. The
    in-process reference runs while the worker starts."""
    import logging

    import torch

    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch._private.protocol import GPU_COORD_LABEL
    from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalingConfig,
                                          SliceSpec)
    from ray_tpu_torch.autoscaler.gcp import (INSTANCE_LABEL,
                                              FakeGcpTransport,
                                              GpuVmNodeProvider)
    from ray_tpu_torch.gpu.accelerator import model_of
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    pod = f"{model_of(torch.cuda.get_device_name(0))}-1"
    if not pod.startswith("H100-"):
        print(f"scale (b): the card's pod type is {pod}, not H100-1",
              flush=True)
    booted = {}  # instance name -> (daemon proc, node id, wall s registered)

    def boot(name, kind, labels, metadata):
        resources = json.loads(metadata["rt-resources"])
        h = metadata["rt-host-index"]
        if h == "0":
            resources[f"GPU-{metadata['rt-pod-type']}-head"] = 1.0
        proc, info = node_mod.start_node_daemon(
            addr, session_dir, resources=resources,
            labels={"gpu-domain-name": metadata["rt-slice-name"],
                    "gpu-pod-type": metadata["rt-pod-type"],
                    GPU_COORD_LABEL: f"0,{h}", INSTANCE_LABEL: name})
        booted[name] = (proc, info["node_id"], time.time())
        return lambda: node_mod.kill_process(proc)

    # a reconcile that raises is logged by the loop and decides nothing:
    # count the records (the gate wants none)
    failures = []

    class _Count(logging.Handler):
        def emit(self, record):
            failures.append(record.getMessage()
                            + (f": {record.exc_info[1]!r}"
                               if record.exc_info else ""))

    as_log = logging.getLogger("ray_tpu_torch.autoscaler")
    counter = _Count(logging.ERROR)
    as_log.addHandler(counter)
    as_log.propagate = False
    transport = FakeGcpTransport(boot=boot)
    scaler = Autoscaler(
        GpuVmNodeProvider(project="chip-smoke", zone="local",
                          control_address=addr, transport=transport,
                          cluster_name="scale"),
        AutoscalingConfig(
            min_workers=0, max_workers=0, idle_timeout_s=SCALE_IDLE_S,
            poll_period_s=SCALE_POLL_S,
            slice_types={pod: SliceSpec(hosts=1,
                                        resources_per_host=SCALE_DOMAIN)},
            max_slices=1)).start()
    out = {"pod_type": pod}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scale_")
    try:
        config = dict(cfg=SCALE_CFG, lr=TRAIN_LR, remat=TRAIN_REMAT,
                      seed=SEED, tokens=_train_tokens_np(),
                      steps=SCALE_STEPS)
        trainer = TorchTrainer(
            _scale_train_fn, train_loop_config=config,
            scaling_config=ScalingConfig(
                num_workers=1, use_gpu=True, topology="1x1",
                accelerator_type=pod),
            run_config=RunConfig(name="scale", storage_path=tmp))
        box = {}
        t_fit = time.time()
        fit = threading.Thread(target=lambda: box.update(
            result=trainer.fit()), daemon=True)
        fit.start()
        t = time.monotonic()
        state, train_step, data_dev = _ops_model(SCALE_CFG, TRAIN_LR,
                                                 TRAIN_REMAT, SEED, dev)
        tokens = _train_tokens(data_dev)
        reference = []
        for _ in range(SCALE_STEPS):
            state, loss = train_step(state, tokens)
            reference.append(float(loss))
        del state, tokens
        _ops_counts()   # the reference's launches are not the path's
        torch.cuda.empty_cache()
        out["reference_s"] = time.monotonic() - t
        fit.join(600)
        _check(not fit.is_alive() and "result" in box,
               "scale (b): fit did not return")
        result = box["result"]
        t_idle = time.monotonic()
        _check(result.error is None, f"scale (b): fit failed: {result.error}")
        hist = [m for m in result.metrics_history if "loss" in m]
        domain_nodes = [nid for _, nid, _ in booted.values()]
        # the domain is ALIVE once its last daemon has registered
        alive_at = max((at for _, _, at in booted.values()), default=None)
        slices = [dict(s, nodes=[{k: v for k, v in n.items() if k != "proc"}
                                 for n in s["nodes"]])
                  for s in scaler.slices]
        # the idle domain scales in: drained, then terminated, before stop()
        _scale_wait(lambda: set(domain_nodes) <= set(scaler._draining)
                    or not scaler.slices, SCALE_WAIT_S,
                    "the idle domain was not drained")
        out["idle_to_drain_s"] = time.monotonic() - t_idle
        _scale_wait(lambda: not scaler.slices, SCALE_WAIT_S,
                    "the drained domain was not terminated")
        out["idle_to_terminated_s"] = time.monotonic() - t_idle
        out["idle_daemons_exited"] = _scale_wait(
            lambda: all(p.poll() is not None for p, _, _ in booted.values()),
            30, "the domain's daemons did not exit")
        out["idle_left_instances"] = sorted(transport.instances)
        out["deaths"] = [(_scale_node(rt, nid) or {}).get("death")
                         for nid in domain_nodes]
        inserts = [u for m, u in transport.calls
                   if m == "POST" and "/instances" in u]
        out.update(
            slices=slices, inserts=len(inserts),
            instances=sorted(transport.instances),
            domain_nodes=domain_nodes,
            labels=[(_scale_node(rt, nid) or {}).get("labels")
                    for nid in domain_nodes],
            losses=[m["loss"] for m in hist], reference=reference,
            steps=[m["step"] for m in hist],
            nodes=sorted({m["node"] for m in hist}),
            devices=sorted({m["device"] for m in hist}),
            launches_per_step=[m["launches"] for m in hist],
            launches={k: sum(m["launches"][k] for m in hist)
                      for k in ("k1", "k2", "k3")},
            fit_to_alive_s=(alive_at - t_fit) if alive_at else None,
            fit_to_first_step_s=(hist[0]["t_step_end"] - t_fit
                                 if hist else None),
            fit_s=time.time() - t_fit)
    finally:
        t = time.monotonic()
        scaler.stop()
        gone = all(p.poll() is not None for p, _, _ in booted.values())
        deadline = time.monotonic() + 30
        while not gone and time.monotonic() < deadline:
            time.sleep(0.05)
            gone = all(p.poll() is not None for p, _, _ in booted.values())
        out["stop_to_terminated_s"] = time.monotonic() - t
        as_log.removeHandler(counter)
        as_log.propagate = True
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(left_instances=sorted(transport.instances),
               domain_daemons_exited=gone,
               reconcile_failures=len(failures),
               first_failure=failures[0] if failures else None)
    print(json.dumps({"scale_domain": out}, default=str), flush=True)
    print(f"scale (b): domain {pod} ALIVE {out['fit_to_alive_s']} s after "
          f"fit(), first step {out['fit_to_first_step_s']:.2f} s after; "
          f"idle to drained {out['idle_to_drain_s']:.2f} s, to terminated "
          f"{out['idle_to_terminated_s']:.2f} s (idle timeout "
          f"{SCALE_IDLE_S} s); stop() after it "
          f"{out['stop_to_terminated_s']:.2f} s; reference "
          f"{out['reference_s']:.2f} s beside the start; "
          f"{out['reconcile_failures']} reconciles failed "
          f"({out['first_failure']})", flush=True)
    L = SCALE_CFG["n_layers"]
    _check(out["inserts"] == 1 and len(out["slices"]) == 1
           and len(domain_nodes) == 1,
           f"scale (b): {out['inserts']} inserts, slices {out['slices']}, "
           f"domain nodes {domain_nodes}")
    _check(out["steps"] == list(range(1, SCALE_STEPS + 1))
           and out["nodes"] == domain_nodes,
           f"scale (b): steps {out['steps']} on {out['nodes']}, the domain "
           f"is {domain_nodes}")
    _check(all(d == torch.cuda.get_device_name(0) for d in out["devices"]),
           f"scale (b): the worker ran on {out['devices']}")
    _check(all(c == dict(k1=2 * L, k2=L, k3=L)
               for c in out["launches_per_step"]),
           f"scale (b): launches a step {out['launches_per_step']}")
    _check(out["losses"] == reference,
           f"scale (b): losses {out['losses']} against {reference} in "
           f"process (bitwise)")
    _check(out["reconcile_failures"] == 0,
           f"scale (b): {out['reconcile_failures']} reconciles failed, the "
           f"first: {out['first_failure']}")
    _check(not out["idle_left_instances"] and out["idle_daemons_exited"],
           f"scale (b): once the idle domain was terminated, instances "
           f"{out['idle_left_instances']}, daemons exited "
           f"{out['idle_daemons_exited']}")
    _check(all((d or {}).get("expected") is True for d in out["deaths"]),
           f"scale (b): the domain's death records {out['deaths']}")
    _check(not out["left_instances"] and gone,
           f"scale (b): after stop() instances {out['left_instances']}, "
           f"domain daemons exited {gone}")
    return out


def phase_scale(dev):
    """The autoscaler on the card (see the module docstring): (a) a GPU
    worker for a GPU task, then (b) an NVLink domain for a trainer, on one
    head with no GPU."""
    import torch

    import ray_tpu_torch as rt

    t_phase = time.monotonic()
    # the head must have no GPU: the card comes only through the autoscaler
    os.environ.pop("RT_GPU_AUTODETECT", None)
    t = time.monotonic()
    info = rt.init(num_cpus=SCALE_CPUS)
    out = {"cluster_start_s": time.monotonic() - t}
    from ray_tpu_torch._private.worker import global_context

    system_pids = [p.pid for p in global_context().owned_processes]
    session_dir = info["session_dir"]
    try:
        _check("GPU" not in rt.cluster_resources(),
               f"scale: the head has a GPU: {rt.cluster_resources()}")
        t = time.monotonic()
        out["worker"] = _scale_worker(rt, info["address"], session_dir)
        out["worker_s"] = time.monotonic() - t
        t = time.monotonic()
        out["domain"] = _scale_domain(rt, dev, info["address"], session_dir)
        out["domain_s"] = time.monotonic() - t
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while (_cluster_pids(session_dir, system_pids)
           and time.monotonic() < deadline):
        time.sleep(0.2)
    left = _cluster_pids(session_dir, system_pids)
    out["left_after_shutdown"] = left
    out["launches"] = {k: out["worker"]["launches"][k]
                       + out["domain"]["launches"][k]
                       for k in ("k1", "k2", "k3")}
    out["phase_s"] = time.monotonic() - t_phase
    torch.cuda.empty_cache()
    print(f"scale: phase {out['phase_s']:.1f} s (cluster "
          f"{out['cluster_start_s']:.1f}, (a) {out['worker_s']:.1f}, (b) "
          f"{out['domain_s']:.1f}); launches {out['launches']}", flush=True)
    _check(not left, f"scale: processes left after shutdown: {left}")
    return out


def _path_launches(report, key):
    """``key``'s launches in the trainer, stages, apps, data, ops and scale
    phases' runs (the train worker's steps, both pipelines' steps over
    their stages, the apps' prefill worker and engines, the steps fed by a
    Dataset, the ops phase's profiled step, tune trials, GPU job and
    preempted trainer, the autoscaled worker's task and the autoscaled
    domain's trainer)."""
    return sum(report[p]["launches"].get(key, 0)
               for p in ("trainer", "stages", "apps", "data", "ops", "scale")
               if p in report)


def kernels_line(report):
    """The kernels record: each kernel at its main path's shape, with the
    launches of that path's run (K1: the serve phase; K2/K3: the train
    phase's timed steps; K4, K5a, K5b: the ring phase's timed training
    steps, over its 4 ranks), K1-K3 with the launches of the trainer,
    stages, apps, data, ops and scale phases added (``_path_launches``)."""
    line = []
    if "k1" in report and "serve" in report:
        row = next(r for r in report["k1"] if r["causal"] and (
            r["b"], r["h"], r["kvh"], r["s"], r["hd"]) == K1_MAIN_SHAPE)
        line.append({
            "name": "flash_fwd (K1)", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/flash_attention.py:122",
            "launches": report["serve"]["k1_launches"]
            + _path_launches(report, "k1"),
            "max_abs_err": max(r["err_o"] for r in report["k1"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["sdpa_ms"],
        })
    if "k23" in report and "train" in report:
        row = next(r for r in report["k23"] if r["causal"] and (
            r["b"], r["h"], r["kvh"], r["s"], r["hd"]) == K23_MAIN_SHAPE)
        for key, name, line_no, errs, src in (
                ("k2", "flash_bwd_dq (K2)", 275, ("err_dq",), "flash_bwd.cu"),
                ("k3", "flash_bwd_dkv (K3)", 320, ("err_dk", "err_dv"),
                 "flash_bwd_dkv.cu")):
            line.append({
                "name": name, "route": "cuda",
                "source": f"ray_tpu_torch/csrc/{src}",
                "replaces": f"ray_tpu/ops/flash_attention.py:{line_no}",
                "launches": report["train"]["launches"][key]
                + _path_launches(report, key),
                "max_abs_err": max(r[e] for r in report["k23"] for e in errs),
                "ms": row[f"{key}_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row[f"{key}_bound_ms"],
                "bound_by": row[f"{key}_bound_by"],
                # SDPA's backward computes K2's and K3's work in one call
                "library_ms": row["sdpa_bwd_ms"],
            })
    # K4 and K5 at the training ring's unmasked hop, with the launches of
    # the ring phase's timed training steps (over the 4 ranks)
    if "k4" in report and "ring" in report:
        row = next(r for r in report["k4"] if not r["causal"]
                   and r["state"] == "carried" and (
                       r["b"], r["h"], r["kvh"], r["s"], r["hd"])
                   == HOP_MAIN_SHAPE)
        line.append({
            "name": "flash_chunk (K4)", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_chunk.cu",
            "replaces": "ray_tpu/ops/flash_attention.py:541",
            "launches": report["ring"]["train"]["launches"]["k4"],
            "max_abs_err": max(r["err_o"] for r in report["k4"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # SDPA's forward carries no state: a little less work
            "library_ms": row["sdpa_ms"],
        })
    if "k5" in report and "ring" in report:
        row = next(r for r in report["k5"] if not r["causal"] and (
            r["b"], r["h"], r["kvh"], r["s"], r["hd"]) == HOP_MAIN_SHAPE)
        for key, counter, name, line_no, errs, src in (
                ("k5a", "k2", "flash_bwd_dq fp32 (K5a)", 743, ("err_dq",),
                 "flash_bwd.cu"),
                ("k5b", "k3", "flash_bwd_dkv fp32 (K5b)", 770,
                 ("err_dk", "err_dv"), "flash_bwd_dkv.cu")):
            line.append({
                "name": name, "route": "cuda",
                "source": f"ray_tpu_torch/csrc/{src}",
                "replaces": f"ray_tpu/ops/flash_attention.py:{line_no}",
                "launches": report["ring"]["train"]["launches"][counter],
                "max_abs_err": max(r[e] for r in report["k5"] for e in errs),
                "ms": row[f"{key}_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row[f"{key}_bound_ms"],
                "bound_by": row[f"{key}_bound_by"],
                "library_ms": row["sdpa_bwd_ms"],
            })
    return line


def _timed(record, name, fn, *args):
    """``fn(*args)``, its wall seconds stored under ``record[name]``."""
    t = time.monotonic()
    try:
        return fn(*args)
    finally:
        record[name] = time.monotonic() - t


PHASES = ("k1", "k23", "k4", "k5", "route", "forward", "serve", "train",
          "ring", "shard", "pipe", "vit", "moe", "ckpt", "rl", "runtime",
          "trainer", "stages", "apps", "data", "algos", "collective", "ops",
          "scale")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--ops-job"]:  # the ops phase's GPU job
        return _ops_job_main(float(argv[1]))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases)}")

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA "
              "card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ray_tpu_torch.ops import _build
    except ImportError as e:
        _fail(f"ray_tpu_torch is not beside chip_smoke.py: {e}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    _check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.monotonic()
    paths = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"build: {build_s:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})",
          flush=True)
    binfo = build_info(paths)
    print(json.dumps({"build_info": binfo}), flush=True)

    report = {"card": card, "build_s": build_s, "build_info": binfo}
    phase_s = report["phase_s"] = {}
    try:
        _run_phases(phases, dev, card, report, phase_s)
    finally:  # the seconds of the phases that ran, a failed one included
        print(json.dumps({"phase_s": phase_s}), flush=True)
    report["kernels"] = kernels_line(report)
    if report["kernels"]:
        print(json.dumps({"kernels": report["kernels"]}), flush=True)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _run_phases(phases, dev, card, report, phase_s):
    """Each phase of ``phases`` in order, its report under its name and its
    seconds in ``phase_s``."""
    import torch

    if "k1" in phases:
        report["k1"] = _timed(phase_s, "k1", phase_k1, dev)
    if "k23" in phases:
        report["k23"] = _timed(phase_s, "k23", phase_k23, dev)
    if "k4" in phases:
        report["k4"] = _timed(phase_s, "k4", phase_k4, dev)
    if "k5" in phases:
        report["k5"] = _timed(phase_s, "k5", phase_k5, dev)
    if "route" in phases:
        report["route"] = _timed(phase_s, "route", phase_route, dev)
    if phases & {"forward", "serve"}:
        report.update(_timed(phase_s, "forward_serve", phase_model, dev,
                             phases))
    if "train" in phases:
        report["train"] = _timed(phase_s, "train", phase_train, dev)
    if "ring" in phases:
        torch.cuda.empty_cache()
        report["ring"] = _timed(phase_s, "ring", phase_ring, dev)
    if phases & {"shard", "pipe"}:
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ref_")
        try:
            ref_path = os.path.join(tmp, "step1.pt")
            ref = (ref_path, _timed(phase_s, "shard_reference",
                                    _shard_reference, dev, ref_path))
            if "shard" in phases:
                report["shard"] = _timed(phase_s, "shard", phase_shard,
                                         dev, ref)
            if "pipe" in phases:
                torch.cuda.empty_cache()
                report["pipe"] = _timed(phase_s, "pipe", phase_pipe, dev,
                                        ref)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if "vit" in phases:
        torch.cuda.empty_cache()
        report["vit"] = _timed(phase_s, "vit", phase_vit, dev)
    if "moe" in phases:
        torch.cuda.empty_cache()
        report["moe"] = _timed(phase_s, "moe", phase_moe, dev)
    if "ckpt" in phases:
        torch.cuda.empty_cache()
        report["ckpt"] = _timed(phase_s, "ckpt", phase_ckpt, dev)
    if "rl" in phases:
        torch.cuda.empty_cache()
        report["rl"] = _timed(phase_s, "rl", phase_rl, dev)
    if "runtime" in phases:
        report["runtime"] = _timed(phase_s, "runtime", phase_runtime, dev,
                                   report.get("serve"))
    if "trainer" in phases:
        torch.cuda.empty_cache()
        report["trainer"] = _timed(phase_s, "trainer", phase_trainer, dev)
    if "stages" in phases:
        torch.cuda.empty_cache()
        report["stages"] = _timed(phase_s, "stages", phase_stages, dev)
    if "apps" in phases:
        torch.cuda.empty_cache()
        report["apps"] = _timed(phase_s, "apps", phase_apps, report)
    if "data" in phases:
        torch.cuda.empty_cache()
        report["data"] = _timed(phase_s, "data", phase_data, dev)
    if "algos" in phases:
        torch.cuda.empty_cache()
        report["algos"] = _timed(phase_s, "algos", phase_algos, dev, card)
    if "collective" in phases:
        torch.cuda.empty_cache()
        report["collective"] = _timed(phase_s, "collective",
                                      phase_collective, dev)
    if "ops" in phases:
        torch.cuda.empty_cache()
        report["ops"] = _timed(phase_s, "ops", phase_ops, dev, card)
    if "scale" in phases:
        torch.cuda.empty_cache()
        report["scale"] = _timed(phase_s, "scale", phase_scale, dev)


if __name__ == "__main__":
    sys.exit(main())
