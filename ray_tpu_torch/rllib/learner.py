"""PPO, IMPALA (V-trace) and APPO learners in PyTorch — counterpart of
``ray_tpu/rllib/learner.py``.

The policy and value networks are MLPs held as the JAX package holds
them: a list of ``{"w": (in, out), "b": (out,)}`` layers, so
``get_weights`` / ``set_weights`` move numpy weights between the two
packages in both directions (``models/convert.py::params_from_jax`` takes
JAX's nest as it is). Adam is torch's with optax.adam's defaults (the same
``m̂ / (sqrt(v̂) + eps)``). Where JAX scans (PPO's minibatches, V-trace's
reverse recursion) the port loops in Python, in the same order. The
products are PyTorch's own: the JAX package computes these MLPs in XLA
and has no kernel for them.

Every learner runs on ``device`` (None means CUDA, which must be there;
``"cpu"`` runs on the CPU). Its random draws come from ``torch.Generator``
objects seeded from ``seed`` on the CPU, so a learner draws the same
weights and shuffles on either device; ``jax.random`` is not reproduced
(give JAX's weights to ``set_weights`` to compare the two).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.convert import nest_map, params_from_jax

# squashed-Gaussian log-std bounds, shared by the SAC learner and the
# env runner's sampling path (they MUST match or the rollout distribution
# silently diverges from the trained one)
LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0

# optax.adam's defaults (b1, b2, eps; eps_root 0)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def init_mlp(generator: torch.Generator, sizes: List[int],
             device=None) -> List[Dict[str, torch.Tensor]]:
    """Orthogonal-init MLP params (the PPO-standard init): gain sqrt(2)
    for the hidden layers and 0.01 for the last, zero biases; drawn on the
    CPU from ``generator``, then moved to ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    params = []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.empty(n_in, n_out)
        torch.nn.init.orthogonal_(
            w, gain=0.01 if i == len(sizes) - 2 else math.sqrt(2.0),
            generator=generator)
        params.append({"w": w.to(dev), "b": torch.zeros(n_out, device=dev)})
    return params


def mlp_apply(params, x):
    for layer in params[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    return x @ params[-1]["w"] + params[-1]["b"]


def policy_logits(params, obs):
    return mlp_apply(params["pi"], obs)


def value_fn(params, obs):
    return mlp_apply(params["vf"], obs)[..., 0]


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                next_values: np.ndarray, terminated: np.ndarray,
                cuts: np.ndarray, gamma: float, lam: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized advantage estimation over one rollout (reference:
    rllib/evaluation/postprocessing.py compute_advantages); numpy, the
    JAX package's, copied.

    `next_values[t]` is V(s_{t+1}) for the TRUE successor state — at a
    truncation boundary that is the pre-reset final observation, so
    truncated episodes bootstrap correctly instead of leaking the next
    episode's value. `terminated[t]` zeroes the bootstrap only on real
    termination; `cuts[t]` (terminated OR truncated) stops the GAE chain
    from crossing any episode boundary."""
    T = len(rewards)
    adv = np.zeros(T, dtype=np.float32)
    last = 0.0
    for t in reversed(range(T)):
        delta = (rewards[t]
                 + gamma * next_values[t] * (1.0 - terminated[t])
                 - values[t])
        last = delta + gamma * lam * (1.0 - cuts[t]) * last
        adv[t] = last
    returns = adv + values
    return adv, returns


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nest of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _trainable(tree):
    """``tree``'s tensors as leaf parameters that require a gradient."""
    for t in leaves(tree):
        t.requires_grad_(True)
    return tree


def _frozen_copy(tree):
    """A copy of ``tree`` without gradients (a target network)."""
    return nest_map(lambda t: t.detach().clone(), tree)


def _adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)`` over the leaves of ``params``."""
    return torch.optim.Adam(leaves(params), lr=lr, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


def to_numpy(tree) -> Any:
    """A nest of tensors as the same nest of numpy arrays (copies)."""
    return nest_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def copy_weights(params, weights):
    """Copy ``weights`` (a nest of arrays as ``get_weights`` gives it, e.g.
    JAX's) into the tensors of ``params``, in place: an optimizer holds
    them by identity."""
    with torch.no_grad():
        for t, w in zip(leaves(params), leaves(params_from_jax(
                weights, "cpu"))):
            if tuple(w.shape) != tuple(t.shape):
                raise ValueError(f"weight of shape {tuple(w.shape)} for a "
                                 f"parameter of shape {tuple(t.shape)}")
            t.copy_(w)


def batch_tensors(batch: Dict[str, np.ndarray], dtypes: Dict[str, Any],
                  device) -> Dict[str, torch.Tensor]:
    """The named columns of ``batch`` as tensors of ``dtypes`` on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(batch[k]), device=device,
                               dtype=dt) for k, dt in dtypes.items()}


def _take(logp_all, actions):
    """logp_all[i, actions[i]]."""
    return logp_all.gather(1, actions[:, None].long())[:, 0]


def _entropy(logp_all):
    return -(torch.exp(logp_all) * logp_all).sum(-1).mean()


class _ActorCritic:
    """What the PPO, IMPALA and APPO learners share: a policy and a value
    MLP, Adam over both, numpy weights in and out."""

    def __init__(self, obs_dim, num_actions, hidden, lr, seed, device):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.params = _trainable({
            "pi": init_mlp(gen, [obs_dim, *hidden, num_actions],
                           self.device),
            "vf": init_mlp(gen, [obs_dim, *hidden, 1], self.device),
        })
        self.opt = _adam(self.params, lr)

    def _step(self, total):
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step()

    def get_weights(self) -> Any:
        return to_numpy(self.params)

    def set_weights(self, weights: Any):
        """Copy in ``weights``; the optimizer state stays, as in JAX."""
        copy_weights(self.params, weights)


PPO_COLUMNS = {"obs": torch.float32, "actions": torch.int64,
               "logp": torch.float32, "advantages": torch.float32,
               "returns": torch.float32}


class PPOLearner(_ActorCritic):
    """Holds params/optimizer; update() runs PPO's epochs of minibatch
    steps."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 hidden: Tuple[int, ...] = (64, 64),
                 lr: float = 3e-4, clip: float = 0.2,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.0,
                 num_epochs: int = 4, minibatch_size: int = 128,
                 seed: int = 0, device=None):
        super().__init__(obs_dim, num_actions, hidden, lr, seed, device)
        self.clip = clip
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.num_epochs = num_epochs
        self.minibatch_size = minibatch_size
        self._shuffle = torch.Generator().manual_seed(seed + 1)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        n = len(batch["obs"])
        m = (n // self.minibatch_size) * self.minibatch_size
        if m == 0:
            m = n  # one undersized minibatch
        mb = batch_tensors({k: np.asarray(batch[k])[:m]
                            for k in PPO_COLUMNS}, PPO_COLUMNS, self.device)
        return _ppo_update(self, mb)


def _loss(params, mb, clip, vf_coeff, entropy_coeff):
    logp_all = torch.log_softmax(policy_logits(params, mb["obs"]), -1)
    logp = _take(logp_all, mb["actions"])
    ratio = torch.exp(logp - mb["logp"])
    adv = mb["advantages"]
    # jnp.std is the population std (ddof 0); torch's default is ddof 1
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v = value_fn(params, mb["obs"])
    vf_loss = 0.5 * ((v - mb["returns"]) ** 2).mean()
    entropy = _entropy(logp_all)
    total = pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy
    return total, (pg_loss, vf_loss, entropy)


def _ppo_update(learner: PPOLearner, batch) -> Dict[str, float]:
    """``num_epochs`` epochs, each over a fresh shuffle (``torch.randperm``
    from the learner's generator) cut into n // minibatch_size
    minibatches, one Adam step each; the metrics are the means over every
    step, as JAX's scan stacks them."""
    n = batch["obs"].shape[0]
    num_mb = max(1, n // learner.minibatch_size)
    size = n // num_mb
    stats = []
    for _ in range(learner.num_epochs):
        perm = torch.randperm(n, generator=learner._shuffle).to(
            learner.device)
        for i in range(num_mb):
            rows = perm[i * size:(i + 1) * size]
            total, aux = _loss(learner.params,
                               {k: v[rows] for k, v in batch.items()},
                               learner.clip, learner.vf_coeff,
                               learner.entropy_coeff)
            learner._step(total)
            stats.append(torch.stack([total.detach(), *(a.detach()
                                                        for a in aux)]))
    loss, pg, vf, ent = torch.stack(stats).mean(0).tolist()
    return {"total_loss": loss, "policy_loss": pg, "vf_loss": vf,
            "entropy": ent}


# ---------------------------------------------------------------------------
# IMPALA / V-trace (reference: rllib/algorithms/impala/impala.py:526 +
# vtrace targets from Espeholt et al. — off-policy correction so stale
# behavior policies from async sampling still yield on-policy gradients)
# ---------------------------------------------------------------------------

VTRACE_COLUMNS = {"obs": torch.float32, "next_obs": torch.float32,
                  "actions": torch.int64, "logp": torch.float32,
                  "rewards": torch.float32, "terminated": torch.float32,
                  "cut": torch.float32}


def _vtrace_targets(logp, v_src, next_v_src, batch, *, gamma, rho_bar,
                    c_bar):
    """Shared V-trace recursion: given behavior-corrected log-probs and
    the (detached) value source, return (vs, pg_adv, rho_sg). The value
    source is the LIVE network for IMPALA and the lagging TARGET network
    for APPO. The reverse scan is a Python loop over the rollout, in JAX's
    order; ``cut`` (terminal or truncation) breaks the chain, and a chain's
    last step bootstraps from ``next_v_src[-1]``."""
    not_term = 1.0 - batch["terminated"]
    not_cut = 1.0 - batch["cut"]
    rho = torch.clamp_max(torch.exp(logp - batch["logp"]), rho_bar)
    c = torch.clamp_max(rho, c_bar).detach()
    rho_sg = rho.detach()
    delta = rho_sg * (batch["rewards"] + gamma * next_v_src * not_term
                      - v_src)
    disc = gamma * not_cut
    carry = torch.zeros((), device=delta.device)
    out = []
    for t in reversed(range(delta.shape[0])):
        carry = delta[t] + disc[t] * c[t] * carry
        out.append(carry)
    vs = v_src + torch.stack(out[::-1])
    # vs_{t+1}: next step's vs inside a chain; bootstrap value at a cut
    vs_next = torch.where(not_cut.bool(),
                          torch.cat([vs[1:], next_v_src[-1:]]), next_v_src)
    pg_adv = rho_sg * (batch["rewards"] + gamma * vs_next * not_term
                       - v_src)
    return vs, pg_adv, rho_sg


def _vtrace_loss(params, batch, *, gamma, rho_bar, c_bar, vf_coeff,
                 entropy_coeff):
    logp_all = torch.log_softmax(policy_logits(params, batch["obs"]), -1)
    logp = _take(logp_all, batch["actions"])
    v = value_fn(params, batch["obs"])
    next_v = value_fn(params, batch["next_obs"])
    vs, pg_adv, _rho = _vtrace_targets(
        logp, v.detach(), next_v.detach(), batch, gamma=gamma,
        rho_bar=rho_bar, c_bar=c_bar)
    pg_loss = -(pg_adv * logp).mean()
    vf_loss = 0.5 * ((v - vs) ** 2).mean()
    entropy = _entropy(logp_all)
    total = pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy
    return total, (pg_loss, vf_loss, entropy)


def _appo_loss(params, target_params, batch, *, gamma, rho_bar, c_bar,
               clip_param, vf_coeff, entropy_coeff):
    """APPO loss (reference: rllib/algorithms/appo/torch/appo_torch_learner
    .py): PPO's clipped surrogate on V-TRACE advantages, with the V-trace
    targets computed from a lagging TARGET value network."""
    logp_all = torch.log_softmax(policy_logits(params, batch["obs"]), -1)
    logp = _take(logp_all, batch["actions"])
    v = value_fn(params, batch["obs"])
    tv = value_fn(target_params, batch["obs"]).detach()
    tnext_v = value_fn(target_params, batch["next_obs"]).detach()
    vs, pg_adv, _rho = _vtrace_targets(
        logp, tv, tnext_v, batch, gamma=gamma, rho_bar=rho_bar, c_bar=c_bar)
    pg_adv = pg_adv.detach()
    ratio = torch.exp(logp - batch["logp"])
    surr = torch.minimum(
        ratio * pg_adv,
        torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * pg_adv)
    pg_loss = -surr.mean()
    vf_loss = 0.5 * ((v - vs) ** 2).mean()
    entropy = _entropy(logp_all)
    total = pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy
    return total, (pg_loss, vf_loss, entropy)


def _metrics(total, aux) -> Dict[str, float]:
    loss, pg, vf, ent = torch.stack(
        [total.detach(), *(a.detach() for a in aux)]).tolist()
    return {"total_loss": loss, "policy_loss": pg, "vf_loss": vf,
            "entropy": ent}


class APPOLearner(_ActorCritic):
    """APPO learner (reference: appo.py — async PPO): clipped-surrogate
    updates per arriving fragment, V-trace advantages against a target
    value network refreshed every `target_update_freq` updates."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 hidden: Tuple[int, ...] = (64, 64), lr: float = 5e-4,
                 gamma: float = 0.99, rho_bar: float = 1.0, c_bar: float = 1.0,
                 clip_param: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, target_update_freq: int = 8,
                 seed: int = 0, device=None):
        super().__init__(obs_dim, num_actions, hidden, lr, seed, device)
        self.target_params = _frozen_copy(self.params)
        self.target_update_freq = target_update_freq
        self._updates = 0
        self._hp = dict(gamma=gamma, rho_bar=rho_bar, c_bar=c_bar,
                        clip_param=clip_param, vf_coeff=vf_coeff,
                        entropy_coeff=entropy_coeff)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        total, aux = _appo_loss(
            self.params, self.target_params,
            batch_tensors(batch, VTRACE_COLUMNS, self.device), **self._hp)
        self._step(total)
        self._updates += 1
        if self._updates % self.target_update_freq == 0:
            self.target_params = _frozen_copy(self.params)
        return _metrics(total, aux)


class VTraceLearner(_ActorCritic):
    """IMPALA learner: one SGD step per arriving fragment, with V-trace
    off-policy correction (reference: impala TorchLearner loss)."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 hidden: Tuple[int, ...] = (64, 64), lr: float = 5e-4,
                 gamma: float = 0.99, rho_bar: float = 1.0, c_bar: float = 1.0,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 seed: int = 0, device=None):
        super().__init__(obs_dim, num_actions, hidden, lr, seed, device)
        self._hp = dict(gamma=gamma, rho_bar=rho_bar, c_bar=c_bar,
                        vf_coeff=vf_coeff, entropy_coeff=entropy_coeff)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        total, aux = _vtrace_loss(
            self.params, batch_tensors(batch, VTRACE_COLUMNS, self.device),
            **self._hp)
        self._step(total)
        return _metrics(total, aux)
