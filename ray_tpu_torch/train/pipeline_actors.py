"""Actor-plane pipeline parallelism — stage actors + 1F1B microbatch
schedule over the object store. The port of ``ray_tpu/train/
pipeline_actors.py``.

This is the reference-shaped PP path (reference:
python/ray/dag/compiled_dag_node.py:813 — compiled actor DAGs exist to
drive PP through preallocated channels;
python/ray/experimental/channel/torch_tensor_accelerator_channel.py:1).
Each pipeline stage is an actor owning a contiguous slice of layers (+ the
embedding on the first stage, norm + LM head on the last), with a forward
run without autograd and a backward that recomputes the stage under
autograd (JAX's jitted ``stage_fwd`` / ``stage_bwd`` remat). Activations
and gradients hand off through the shared-memory object plane as CPU
tensors in the compute dtype (JAX's leave as numpy arrays; numpy has no
bf16), host-staged as every tensor that crosses processes in the port's
runtime is (the device object plane keeps a tensor on the device only for
a reader in the process that put it). The driver submits ops in per-stage 1F1B order; because
actor queues execute strictly in submission order and argument refs gate
delivery, the classic one-forward-one-backward interleave — bounding live
residuals per stage at (S - stage) instead of M — emerges from ordinary
task ordering, no channel protocol needed.

The SPMD pipeline (ray_tpu_torch/parallel/pipeline.py, "pp" mesh axis,
one process a stage over torch.distributed) is the collective fast path;
this actor version covers the reference's cross-process shape — stages
can live in different processes, hosts, or failure domains, and compose
with the scheduler (placement groups pin stages to nodes). On one card
the stages share it, each in its own process and CUDA context (a stage
actor without a GPU lease inherits the node's devices).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch


def _slice_layers(layers: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    # a copy, so the rest of the full tree is freed
    return {k: v[lo:hi].clone() for k, v in layers.items()}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@ray_tpu_torch.remote
class PipelineStage:
    """One pipeline stage: a contiguous block of decoder layers.

    Stages initialize the FULL parameter tree from the same seed (the
    port's ``init_params``) or take it as ``params`` (a nest of numpy
    arrays, ``models/convert.py::params_from_jax``'s input: JAX's weights)
    and keep only their slice — identical to a single-stage run's init,
    which is what makes the loss-parity test exact (AdamW is elementwise,
    so per-slice AdamW == sliced full-tree AdamW). ``device`` defaults to
    CUDA. The stage counts, for each optimizer step, the flash kernels it
    launched and the bytes it handed on (``stats``).
    """

    def __init__(self, cfg, stage_id: int, n_stages: int, seed: int = 0,
                 learning_rate: float = 3e-4, params=None, device=None):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.models._sharded import adamw
        from ray_tpu_torch.models.convert import params_from_jax
        from ray_tpu_torch.models.llama import init_params
        from ray_tpu_torch.parallel.mesh import tree_leaves

        self.cfg = cfg
        self.sid = stage_id
        self.S = n_stages
        self.first = stage_id == 0
        self.last = stage_id == n_stages - 1
        self.dev = resolve_device(device)
        L = cfg.n_layers
        assert L % n_stages == 0
        self.per = per = L // n_stages
        full = (params_from_jax(params, self.dev) if params is not None
                else init_params(cfg, seed, device=self.dev))
        stage: Dict[str, Any] = {
            "layers": _slice_layers(full["layers"], stage_id * per,
                                    (stage_id + 1) * per),
        }
        if self.first:
            stage["tok_emb"] = full["tok_emb"]
        if self.last:
            stage["norm"] = full["norm"]
            stage["lm_head"] = full["lm_head"]
        del full
        self.params = stage
        self._leaves = tree_leaves(stage)
        for t in self._leaves:
            t.requires_grad_(True)
        self.opt = adamw(self._leaves, learning_rate)
        self._residuals: Dict[int, Any] = {}  # mb_id -> (x, tokens)
        self._n_acc = 0
        self._handoff_bytes = 0
        self._seen = self._launches()
        self._steps: List[dict] = []

    @staticmethod
    def _launches() -> Dict[str, int]:
        from ray_tpu_torch.ops import flash_attention as fa

        return {"k1": fa.flash_fwd_launches, "k2": fa.flash_bwd_dq_launches,
                "k3": fa.flash_bwd_dkv_launches}

    def _stage_fwd(self, x, tokens):
        """x: activations from the previous stage ((mb, s, d)) or None for
        the first stage (embeds `tokens` itself). Returns activations or,
        on the last stage, the microbatch's mean NLL (fp32)."""
        import torch

        from ray_tpu_torch.models.llama import (_embed, _head, _layer,
                                                _logits, rms_norm,
                                                rope_tables)

        cfg, p = self.cfg, self.params
        if self.first:
            h = _embed(cfg, None, p["tok_emb"], tokens)
        else:
            h = x.to(cfg.dtype)
        cos, sin = rope_tables(
            cfg, torch.arange(tokens.shape[1], device=tokens.device))
        # one unbind per stacked weight (as ``_backbone``): the backward
        # stacks each weight's layer gradients once
        stacked = {k: w.unbind(0) for k, w in p["layers"].items()}
        for i in range(self.per):
            h = _layer(cfg, None, h, {k: ws[i] for k, ws in stacked.items()},
                       cos, sin)
        if not self.last:
            return h
        h = rms_norm(h, p["norm"], cfg.norm_eps)
        logits = _logits(cfg, None, h, _head(cfg, None, p["lm_head"])).float()
        logp = torch.log_softmax(logits, dim=-1)
        tgt = tokens[:, 1:].long()
        nll = -torch.gather(logp[:, :-1], -1, tgt[..., None])[..., 0]
        return nll.mean()

    # -- schedule ops ---------------------------------------------------

    def forward(self, mb_id: int, x, tokens):
        """Run this stage's forward for microbatch `mb_id` without autograd,
        saving the (input, tokens) residuals for the rematerialized
        backward. Returns activations as a CPU tensor (or the scalar loss
        on the last stage)."""
        import torch

        x = None if x is None else x.to(self.dev)
        tokens = torch.as_tensor(np.asarray(tokens)).to(self.dev)
        with torch.no_grad():
            out = self._stage_fwd(x, tokens)
        self._residuals[mb_id] = (x, tokens)
        if self.last:
            return float(out)
        out = out.cpu()
        self._handoff_bytes += _nbytes(out)
        return out

    def backward(self, mb_id: int, dy=None):
        """Backward for microbatch `mb_id`; `dy` is the activation gradient
        from the next stage (None on the last stage — the loss seeds it).
        Recomputes the stage under autograd (per-stage activation remat —
        the standard PP memory/compute trade), accumulates parameter
        grads; returns dx for the previous stage as a CPU tensor (or None
        on the first)."""
        import torch

        x, tokens = self._residuals.pop(mb_id)
        if x is not None:
            x = x.detach().requires_grad_(True)
        inputs = self._leaves + ([] if x is None else [x])
        with torch.enable_grad():
            out = self._stage_fwd(x, tokens)
            seed = None if self.last else dy.to(self.dev, out.dtype)
            grads = torch.autograd.grad(out, inputs, grad_outputs=seed)
        with torch.no_grad():
            for t, g in zip(self._leaves, grads):
                if t.grad is None:
                    t.grad = g
                else:
                    t.grad += g
        self._n_acc += 1
        if self.first:
            return None
        dx = grads[-1].cpu()
        self._handoff_bytes += _nbytes(dx)
        return dx

    def apply_gradients(self):
        """Average accumulated microbatch grads and take one AdamW step."""
        import torch

        assert self._n_acc and not self._residuals, (
            "apply_gradients before all backwards completed")
        with torch.no_grad():
            for t in self._leaves:
                t.grad /= self._n_acc
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self._n_acc = 0
        now = self._launches()
        self._steps.append(dict(
            {k: now[k] - self._seen[k] for k in now},
            handoff_bytes=self._handoff_bytes))
        self._seen, self._handoff_bytes = now, 0
        return True

    def stats(self) -> List[dict]:
        """Per optimizer step: the flash kernels launched (K1, K2, K3) and
        the bytes of activations and gradients handed on."""
        return list(self._steps)


def _one_f_one_b_order(S: int, M: int, sid: int) -> List[tuple]:
    """Per-stage op order implementing 1F1B: warmup of (S - sid) forwards,
    then alternate backward/forward, then drain backwards."""
    warmup = min(M, S - sid)
    ops: List[tuple] = [("F", m) for m in range(warmup)]
    nf, nb = warmup, 0
    while nb < M:
        ops.append(("B", nb))
        nb += 1
        if nf < M:
            ops.append(("F", nf))
            nf += 1
    return ops


def _make_stages(cfg, n_stages, learning_rate, seed, stage_options, params,
                 device):
    stages = []
    for s in range(n_stages):
        klass = PipelineStage
        if stage_options and stage_options[s]:
            # e.g. {"num_gpus": 1}, or a label_selector pinning stages to
            # nodes: cross-node activation/grad edges then ride
            # RemoteChannel in the compiled pipeline
            klass = PipelineStage.options(**stage_options[s])
        stages.append(klass.remote(
            cfg, s, n_stages, seed=seed, learning_rate=learning_rate,
            params=params, device=device))
    return stages


class ActorPipeline:
    """Driver-side handle: S stage actors + the 1F1B step schedule.
    ``params`` and ``device`` go to every ``PipelineStage``."""

    def __init__(self, cfg, n_stages: int, n_microbatches: int,
                 learning_rate: float = 3e-4, seed: int = 0,
                 stage_options: Optional[List[dict]] = None, params=None,
                 device=None):
        self.S = n_stages
        self.M = n_microbatches
        self.stages = _make_stages(cfg, n_stages, learning_rate, seed,
                                   stage_options, params, device)

    def train_step(self, tokens: np.ndarray, timeout: float = 300.0) -> float:
        """One synchronous optimizer step over `tokens` (B, seq); B % M == 0.
        Returns the mean microbatch loss."""
        B = tokens.shape[0]
        assert B % self.M == 0
        mbs = tokens.reshape(self.M, B // self.M, -1)
        S, M = self.S, self.M

        fwd_out: Dict[tuple, Any] = {}   # (sid, mb) -> activation/loss ref
        bwd_out: Dict[tuple, Any] = {}   # (sid, mb) -> dx ref
        # submit in per-stage 1F1B order; refs gate cross-stage dependencies
        # and actor queues serialize per-stage execution in this exact order
        pending: Dict[int, List[tuple]] = {
            s: _one_f_one_b_order(S, M, s) for s in range(S)}
        done: Dict[int, int] = {s: 0 for s in range(S)}
        while any(done[s] < len(pending[s]) for s in range(S)):
            progressed = False
            for s in range(S):
                while done[s] < len(pending[s]):
                    op, m = pending[s][done[s]]
                    if op == "F":
                        x = None if s == 0 else fwd_out.get((s - 1, m))
                        if s > 0 and x is None:
                            break  # predecessor forward not yet submitted
                        fwd_out[(s, m)] = self.stages[s].forward.remote(
                            m, x, mbs[m])
                    else:
                        dy = None if s == S - 1 else bwd_out.get((s + 1, m))
                        if s < S - 1 and dy is None:
                            break  # successor backward not yet submitted
                        bwd_out[(s, m)] = self.stages[s].backward.remote(m, dy)
                    done[s] += 1
                    progressed = True
            assert progressed, "1F1B schedule wedged (cyclic dependency?)"
        losses = ray_tpu_torch.get(
            [fwd_out[(S - 1, m)] for m in range(M)], timeout=timeout)
        ray_tpu_torch.get(
            [st.apply_gradients.remote() for st in self.stages],
            timeout=timeout)
        return float(np.mean(losses))

    def stage_stats(self, timeout: float = 60.0) -> List[List[dict]]:
        """Each stage's ``PipelineStage.stats``."""
        return ray_tpu_torch.get([st.stats.remote() for st in self.stages],
                                 timeout=timeout)

    def shutdown(self):
        for st in self.stages:
            try:
                ray_tpu_torch.kill(st)
            except Exception:  # noqa: BLE001 — already dead
                pass


class CompiledActorPipeline:
    """1F1B pipeline driven through the COMPILED graph path: the whole
    per-step schedule (S stages × M microbatches of forward/backward +
    the optimizer application) is compiled ONCE into per-actor executor
    loops connected by preallocated shm channels — zero task submissions
    per train step (reference: compiled_dag_node.py:813, whose purpose is
    exactly this PP drive; VERDICT r3 next #2).

    The DAG is authored in per-stage 1F1B order, which the compiled plan
    preserves per actor, so the memory profile matches ActorPipeline.

    Every channel slot holds one serialized value: a stage's activation
    (mb x seq x dim in the compute dtype, plus the pickle header) must fit
    ``slot_size``, or that execution fails with the channel's "slot size"
    error (``dag/_compiled.py::_write_val``)."""

    def __init__(self, cfg, n_stages: int, n_microbatches: int,
                 learning_rate: float = 3e-4, seed: int = 0,
                 slot_size: int = 8 << 20,
                 stage_options: Optional[List[dict]] = None, params=None,
                 device=None):
        from ray_tpu_torch.dag import InputNode, MultiOutputNode

        self.S = S = n_stages
        self.M = M = n_microbatches
        self.stages = _make_stages(cfg, n_stages, learning_rate, seed,
                                   stage_options, params, device)
        fwd: Dict[tuple, Any] = {}
        bwd: Dict[tuple, Any] = {}
        with InputNode() as inp:
            pending = {s: _one_f_one_b_order(S, M, s) for s in range(S)}
            done = {s: 0 for s in range(S)}
            while any(done[s] < len(pending[s]) for s in range(S)):
                progressed = False
                for s in range(S):
                    while done[s] < len(pending[s]):
                        op, m = pending[s][done[s]]
                        if op == "F":
                            if s > 0 and (s - 1, m) not in fwd:
                                break
                            x = None if s == 0 else fwd[(s - 1, m)]
                            fwd[(s, m)] = self.stages[s].forward.bind(
                                m, x, inp[m])
                        else:
                            if s < S - 1 and (s + 1, m) not in bwd:
                                break
                            dy = None if s == S - 1 else bwd[(s + 1, m)]
                            bwd[(s, m)] = self.stages[s].backward.bind(m, dy)
                        done[s] += 1
                        progressed = True
                assert progressed, "1F1B authoring wedged"
            applies = [st.apply_gradients.bind() for st in self.stages]
            # stage-0 backwards are sinks (their dx is None): they must be
            # targets or the compile-time DFS would drop the whole backward
            # chain from the plan
            dag = MultiOutputNode(
                [fwd[(S - 1, m)] for m in range(M)]
                + [bwd[(0, m)] for m in range(M)] + applies)
        self._compiled = dag.experimental_compile(
            max_in_flight=2, slot_size=slot_size)

    def train_step(self, tokens: np.ndarray, timeout: float = 300.0) -> float:
        B = tokens.shape[0]
        assert B % self.M == 0
        mbs = tokens.reshape(self.M, B // self.M, -1)
        out = self._compiled.execute(
            {m: mbs[m] for m in range(self.M)}).get(timeout=timeout)
        return float(np.mean(out[:self.M]))

    def teardown(self) -> List[dict]:
        """Stop the compiled graph's executor loops (the stages then take
        ordinary calls again, ``stage_stats``); returns their loop stats."""
        return self._compiled.teardown()

    def stage_stats(self, timeout: float = 60.0) -> List[List[dict]]:
        """Each stage's ``PipelineStage.stats``, after ``teardown``: a
        stage's executor loop holds it until then."""
        return ray_tpu_torch.get([st.stats.remote() for st in self.stages],
                                 timeout=timeout)

    def shutdown(self):
        try:
            self._compiled.teardown()
        except Exception:  # noqa: BLE001 — loops may be dead
            pass
        for st in self.stages:
            try:
                ray_tpu_torch.kill(st)
            except Exception:  # noqa: BLE001 — already dead
                pass
