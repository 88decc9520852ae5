"""The plain reference: a Llama-architecture decoder (Llama-2/3, Mistral
without a sliding window, Yi) as its published description states it, in
float32 with TF32 off, in plain PyTorch, computed in blocks so that it fits
beside nothing else on the card.

Pre-norm RMSNorm, rotary embedding on the rotate-half convention with
inv_freq = theta^(-2i/head_dim), grouped-query attention (query head i
reads kv head i // (heads / kv_heads)), causal softmax attention, a SwiGLU
feed-forward, an untied head; next-token cross entropy; AdamW with
decoupled weight decay (optax.adamw / torch.optim.AdamW). It takes the
weights as the benchmark drew them (the port's dict layout: (L, in, out)
stacked projections) and nothing that the program made, and imports no
part of the program.

``precision="fp8"`` is the control: every weight product computed as an
fp8 GEMM would be, its operands rounded to float8 e4m3 with one scale a
tensor (amax / 448) and, backward, the incoming gradient to e5m2; the
attention and the rest stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import yardstick


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t, dtype=torch.float8_e4m3fn):
    """``t`` rounded to a float8 type with one scale for the tensor."""
    big = torch.finfo(dtype).max
    scale = t.detach().abs().amax().clamp_min(1e-30) / big
    return (t / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w as an fp8 GEMM computes it: e4m3 operands forward, e5m2
    incoming gradients backward, products accumulated in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        gx = gq @ wq.transpose(-1, -2)
        gw = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1)
              @ gq.reshape(-1, gq.shape[-1]))
        return gx, gw


class Reference:
    def __init__(self, mc: Dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.w = yardstick.dims(mc)
        self.theta = float(mc["rope_theta"])
        self.eps = float(mc["rms_norm_eps"])
        self.fp8 = precision == "fp8"
        no_tf32()

    # -- pieces --------------------------------------------------------

    def mm(self, x, w):
        w = w.float()
        return _Fp8Matmul.apply(x, w) if self.fp8 else x @ w

    def rms(self, x, weight):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * weight.float()

    def rope(self, x, pos):
        """x [..., T, heads, hd]; pos [T]."""
        hd = x.shape[-1]
        inv = self.theta ** (-torch.arange(0, hd, 2, device=x.device,
                                           dtype=torch.float64) / hd)
        ang = (pos.double()[:, None] * inv[None]).float()   # [T, hd/2]
        cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
        sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return x * cos + torch.cat([-x2, x1], -1) * sin

    def attention(self, q, k, v, block: int = 512):
        """Causal attention, q [B, T, H, hd], k/v [B, T, KV, hd], in query
        blocks of ``block`` rows."""
        B, T, H, hd = q.shape
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, dim=2).transpose(1, 2)   # [B, H, T, hd]
        v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        outs = []
        for r0 in range(0, T, block):
            r1 = min(T, r0 + block)
            s = (q[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2)) / math.sqrt(hd)
            keep = (torch.arange(r0, r1, device=q.device)[:, None]
                    >= torch.arange(r1, device=q.device)[None, :])
            s = s.masked_fill(~keep, float("-inf"))
            outs.append(torch.softmax(s, -1) @ v[:, :, :r1])
        return torch.cat(outs, 2).transpose(1, 2)              # [B, T, H, hd]

    def layer(self, h, p, pos):
        w = self.w
        B, T, _ = h.shape
        hd = w["head_dim"]
        a = self.rms(h, p["ln1"])
        q = self.mm(a, p["wq"]).view(B, T, w["n_heads"], hd)
        k = self.mm(a, p["wk"]).view(B, T, w["n_kv_heads"], hd)
        v = self.mm(a, p["wv"]).view(B, T, w["n_kv_heads"], hd)
        o = self.attention(self.rope(q, pos), self.rope(k, pos), v)
        h = h + self.mm(o.reshape(B, T, -1), p["wo"])
        a = self.rms(h, p["ln2"])
        return h + self.mm(F.silu(self.mm(a, p["w1"])) * self.mm(a, p["w3"]),
                           p["w2"])

    @staticmethod
    def layer_weights(params: Dict, i: int) -> Dict:
        return {n: t[i] for n, t in params["layers"].items()}

    # -- serving: logits along given sequences ---------------------------

    @torch.no_grad()
    def logits_rows(self, params: Dict, tokens: Sequence[int],
                    rows: Sequence[int]) -> torch.Tensor:
        """fp32 logits [len(rows), vocab] at positions ``rows`` of one
        sequence, each predicting the token after it."""
        dev = params["tok_emb"].device
        tok = torch.as_tensor(list(tokens), device=dev)
        pos = torch.arange(len(tok), device=dev)
        h = params["tok_emb"][tok].float()[None]
        for i in range(self.w["n_layers"]):
            h = self.layer(h, self.layer_weights(params, i), pos)
        h = self.rms(h[0, torch.as_tensor(list(rows), device=dev)],
                     params["norm"])
        return self.mm(h, params["lm_head"])

    # -- training: loss, gradients, AdamW --------------------------------

    def _nll_sum(self, P: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """Summed next-token NLL of a block of rows (the last position has
        no target), every layer and the head under a checkpoint."""
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device)
        h = P["tok_emb"][tokens]
        # one unbind a stacked leaf: its backward stacks the layers' grads once
        stacked = {n: t.unbind(0) for n, t in P["layers"].items()}
        for i in range(self.w["n_layers"]):
            p = {n: ts[i] for n, ts in stacked.items()}
            h = checkpoint(self.layer, h, p, pos, use_reentrant=False)

        def head(h):
            logits = self.mm(self.rms(h[:, :-1], P["norm"]), P["lm_head"])
            return -torch.log_softmax(logits, -1).gather(
                -1, tokens[:, 1:, None]).sum()

        return checkpoint(head, h, use_reentrant=False)

    def train(self, params0: Dict, batches: List[torch.Tensor], hp: Dict,
              sample: Dict[str, torch.Tensor], rows: Optional[int] = None,
              block_tokens: int = 4096) -> Dict:
        """AdamW steps from ``params0`` (not changed) over ``batches``.

        Returns the loss of each step, each leaf's norm of the first
        gradient and its elements at the flat indices ``sample`` gives,
        and each leaf's change after the last step: its norm and its
        elements at the same indices. ``rows``
        keeps only a batch's first rows (a fault the check must catch:
        half of the batch left out, the mean over the rest)."""
        import weights as W

        P0 = W.leaves(params0)
        P = {n: t.detach().float().clone().requires_grad_(True)
             for n, t in P0.items()}
        tree = {"layers": {}}
        for n, t in P.items():
            if n.startswith("layers."):
                tree["layers"][n[7:]] = t
            else:
                tree[n] = t
        m = {n: torch.zeros_like(t) for n, t in P.items()}
        v = {n: torch.zeros_like(t) for n, t in P.items()}
        b1, b2 = hp["betas"]
        lr, eps, wd = hp["learning_rate"], hp["eps"], hp["weight_decay"]
        losses, g1, g1s = [], {}, {}
        for step, tokens in enumerate(batches, start=1):
            tokens = tokens[:rows] if rows else tokens
            b, s = tokens.shape
            count = b * (s - 1)
            per = max(1, block_tokens // s)
            total = 0.0
            for r0 in range(0, b, per):
                nll = self._nll_sum(tree, tokens[r0:r0 + per])
                (nll / count).backward()
                total += float(nll.detach())
            losses.append(total / count)
            with torch.no_grad():
                for n, p in P.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    if step == 1:
                        g1[n] = float(g.norm())
                        g1s[n] = g.reshape(-1)[sample[n]].clone()
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[n] / (1 - b1 ** step)) / (
                        (v[n] / (1 - b2 ** step)).sqrt_() + eps)
                    p.mul_(1 - lr * wd).sub_(upd, alpha=lr)
                    p.grad = None
        change, change_s = {}, {}
        with torch.no_grad():
            for n in P:
                d = (P[n] - P0[n].float()).reshape(-1)
                change[n] = float(d.norm())
                change_s[n] = d[sample[n]].clone()
                del d
        return {"losses": losses, "grad_norms": g1, "grad_sample": g1s,
                "change_norms": change, "change_sample": change_s}
