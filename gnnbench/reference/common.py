"""Plain PyTorch pieces the references share: a matmul in float64 or in
TF32, a weighted edge sum with its own backward, softmax cross-entropy
and the Adam steps. Nothing here imports the program.

References compute in float64: a float32 ``index_add_`` into one row
adds its terms one after another, and on a hub row of 10^5 edges drops
every term under half an ulp of the running sum, so a float32 reference
would be farther from the truth than the program it judges."""

from __future__ import annotations

import torch

__all__ = ["matmul", "to_tf32", "edge_sum", "cross_entropy", "adam_steps"]

# Edges a chunk of :func:`edge_sum`: its (chunk, H, F) float64 transient
# stays near 2 GiB at H F = 256.
CHUNK = 1 << 20


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (8 exponent bits, 10 mantissa bits; nearest,
    ties to even), returned in ``x``'s dtype: what a tensor core reads of
    a float32 operand with TF32 on."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.view(torch.float32).to(x.dtype)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and the products summed in
    their dtype, backward likewise: TF32's rounding on every GEMM of a
    step, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).T, to_tf32(a).T @ g


def matmul(precision: str):
    """The matmul of a reference run: ``float64`` plain, or ``tf32``."""
    if precision == "float64":
        return torch.matmul
    if precision == "tf32":
        return _Tf32Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


class _EdgeSum(torch.autograd.Function):
    """out[dst[e]] += w[e] * x[src[e]] over (N, H, F) rows ``x`` and (E, H)
    weights ``w``, in chunks of edges, saving only its inputs."""

    @staticmethod
    def forward(ctx, src, dst, w, x, n_dst):
        ctx.save_for_backward(src, dst, w, x)
        out = x.new_zeros((n_dst,) + tuple(x.shape[1:]))
        for i in range(0, src.shape[0], CHUNK):
            s, d = src[i:i + CHUNK], dst[i:i + CHUNK]
            out.index_add_(0, d, w[i:i + CHUNK, :, None] * x[s])
        return out

    @staticmethod
    def backward(ctx, g):
        src, dst, w, x = ctx.saved_tensors
        gx = torch.zeros_like(x)
        gw = torch.empty_like(w)
        for i in range(0, src.shape[0], CHUNK):
            s, d = src[i:i + CHUNK], dst[i:i + CHUNK]
            gd = g[d]
            gx.index_add_(0, s, w[i:i + CHUNK, :, None] * gd)
            gw[i:i + CHUNK] = (gd * x[s]).sum(-1)
        return None, None, gw, gx, None


def edge_sum(src, dst, w, x, n_dst: int):
    return _EdgeSum.apply(src, dst, w, x, n_dst)


def cross_entropy(logits, labels):
    """Mean over rows of logsumexp(row) - row[label]."""
    picked = logits.gather(1, labels[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=1) - picked).mean()


def adam_steps(params: dict, loss_fn, steps: int, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """``steps`` Adam steps (Kingma and Ba, with bias correction; no weight
    decay) of ``loss_fn(params)`` from ``params``, which are left as they
    were. A parameter that gets no gradient is not updated, as
    ``torch.optim`` skips it. Returns the loss before each update, each
    parameter's gradient norm at the first step, and the norm of each
    parameter's change over the steps."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], {}
    b1, b2 = betas
    for t in range(1, steps + 1):
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                if t == 1:
                    grad1[k] = 0.0 if g is None else float(g.norm())
                if g is None:
                    continue
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                w.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        del grads, loss
    with torch.no_grad():
        change = {k: float((p[k] - params[k]).norm()) for k in p}
    return {"losses": losses, "grad": grad1, "change": change}
