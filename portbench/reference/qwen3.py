"""Plain reference of the decoder-only model the cells run, in float32 (TF32
off), and the benchmark's weight maker.

The equations are those of the model the program implements (its own
definition of a Qwen3 block, which departs from Hugging Face's in three
places, kept here so that both sides compute one model):

* RMSNorm scales by ``1 + w`` with ``w`` initialised to zero (Hugging Face:
  ``w`` initialised to one);
* the token embeddings are multiplied by sqrt(d_model), rounded to the
  parameters' dtype (Hugging Face does not scale them);
* the logits use a bfloat16 copy of the table (the tied unembedding), in
  the backward pass too.

Per layer: x += Wo attn(rope(qnorm(Wq n1(x))), rope(knorm(Wk n1(x))),
Wv n1(x)) with causal GQA attention, then x += Wd (silu(Wg n2(x)) * Wu
n2(x)); the final norm, then the tied unembedding.  RoPE rotates the two
halves of each head, with f32 angles position * theta ** (-i / (hd / 2)).

``quant=True`` is the control: every dense product takes its two inputs
rounded to float8 e4m3 with one scale per tensor (its largest magnitude at
448), the step below the bfloat16 that the configuration states; the
attention products stay in float32.  Gradients pass the rounding unchanged.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
BF16 = torch.bfloat16
INIT_SCALE = 0.02


def exact_matmuls() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------- weights
def param_table(cfg: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """name -> (shape, init) of the parameters, in the stacked [L, ...]
    layout both sides hold; init is ``normal`` (N(0, 0.02^2)) or
    ``zeros``."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    Fd, V = cfg["intermediate_size"], cfg["vocab_size"]
    if not cfg.get("tie_word_embeddings", False):
        raise ValueError("the reference ties the embedding table")
    return {
        "embed": ((V, D), "normal"),
        "final_norm": ((D,), "zeros"),
        "k_norm": ((L, hd), "zeros"),
        "ln1": ((L, D), "zeros"),
        "ln2": ((L, D), "zeros"),
        "q_norm": ((L, hd), "zeros"),
        "w_down": ((L, Fd, D), "normal"),
        "w_gate": ((L, D, Fd), "normal"),
        "w_up": ((L, D, Fd), "normal"),
        "wk": ((L, D, KV * hd), "normal"),
        "wo": ((L, H * hd, D), "normal"),
        "wq": ((L, D, H * hd), "normal"),
        "wv": ((L, D, KV * hd), "normal"),
    }


def make_weights(cfg: dict, seed: int, device, dtype=BF16
                 ) -> dict[str, torch.Tensor]:
    """The cell's weights from ``seed``, on ``device``, in ``dtype``: one
    draw of every normal parameter at once (a generator on the device), one
    scale, and views of that buffer; the norms are zeros."""
    table = param_table(cfg)
    normal = [(n, s) for n, (s, init) in sorted(table.items())
              if init == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    flat.mul_(INIT_SCALE)
    out, at = {}, 0
    for name, shape in normal:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    for name, (shape, init) in table.items():
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


# ------------------------------------------------------------------- math
def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale (amax at 448), in x's
    dtype, the gradient passed through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


def mm(a, b, quant: bool):
    return (fake_fp8(a) @ fake_fp8(b)) if quant else a @ b


def rms_norm(x, w, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, positions, theta: float):
    """x [B, S, H, hd], positions [S]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = positions.to(F32)[:, None] * freq.to(F32)[None]
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_block(q, k, v, lo: int):
    """q [B, KV, G, bq, hd] of positions lo.., k and v [B, KV, hi, hd]."""
    hd = q.shape[-1]
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k) / math.sqrt(hd)
    qpos = lo + torch.arange(q.shape[3], device=q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    return torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, -1), v)


def attention(q, k, v, block: int = 512):
    """Causal GQA attention, q [B, S, H, hd], k and v [B, S, KV, hd] ->
    [B, S, H * hd], by blocks of query rows (each block's scores recomputed
    in the backward pass)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    outs = []
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        args = (qh[:, :, :, lo:hi], kh[:, :, :hi], vh[:, :, :hi], lo)
        outs.append(checkpoint(_attn_block, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attn_block(*args))
    out = torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)


def layer(cfg: dict, x, w: dict, positions, quant: bool, on_kv=None):
    """One block on x [B, S, D] with this layer's f32 weights ``w``."""
    B, S, D = x.shape
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    h = rms_norm(x, w["ln1"])
    q = mm(h, w["wq"], quant).reshape(B, S, H, hd)
    k = mm(h, w["wk"], quant).reshape(B, S, KV, hd)
    v = mm(h, w["wv"], quant).reshape(B, S, KV, hd)
    q = rope(rms_norm(q, w["q_norm"]), positions, cfg["rope_theta"])
    k = rope(rms_norm(k, w["k_norm"]), positions, cfg["rope_theta"])
    if on_kv is not None:
        on_kv(k, v)
    x = x + mm(attention(q, k, v), w["wo"], quant)
    h = rms_norm(x, w["ln2"])
    y = F.silu(mm(h, w["w_gate"], quant)) * mm(h, w["w_up"], quant)
    return x + mm(y, w["w_down"], quant)


_LAYER = ("ln1", "ln2", "wq", "wk", "wv", "wo", "q_norm", "k_norm",
          "w_gate", "w_up", "w_down")


def embed_scale(cfg: dict, dtype=BF16) -> float:
    return float(torch.tensor(math.sqrt(cfg["hidden_size"])).to(dtype))


def hidden(cfg: dict, params: dict, tokens, *, quant: bool = False,
           remat: bool = False, on_kv=None):
    """Final-normed hidden [B, S, D] f32 of tokens [B, S].  ``params`` may
    be in any dtype: each layer's weights are taken in f32 as it runs.
    ``on_kv(i, k, v)`` sees each layer's rotated k and v."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = F.embedding(tokens.long(), params["embed"].to(F32)) * embed_scale(cfg)
    for i in range(cfg["num_hidden_layers"]):
        w = {k: params[k][i].to(F32) for k in _LAYER}
        hook = None if on_kv is None else (lambda k, v, i=i: on_kv(i, k, v))
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, cfg, x, w, positions, quant, hook,
                           use_reentrant=False)
        else:
            x = layer(cfg, x, w, positions, quant, hook)
    return rms_norm(x, params["final_norm"].to(F32))


def unembed_t(params: dict) -> torch.Tensor:
    """[D, V]: the table rounded to bfloat16, in f32."""
    return params["embed"].to(BF16).to(F32).t()


# ------------------------------------------------------------------ train
def loss_sum(cfg: dict, params: dict, batch: dict, quant: bool = False):
    """Sum over the batch's counted positions of the cross-entropy."""
    h = hidden(cfg, params, batch["tokens"], quant=quant, remat=True)
    # through the table's bf16 copy, as the model is defined: its gradient
    # is rounded to bf16 on the way back to the table
    logits = mm(h, params["embed"].to(BF16).to(F32).t(), quant)
    xent = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, batch["targets"].long()[..., None])[..., 0]
    return (xent * batch["mask"]).sum()


class AdamW:
    """The AdamW the cells train with (decoupled decay on every parameter),
    in f32."""

    def __init__(self, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def update(self, params, grads, m, v, lr: float, step: int):
        t = step + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for n in params:
            g = grads[n]
            m[n] = self.b1 * m[n] + (1 - self.b1) * g
            v[n] = self.b2 * v[n] + (1 - self.b2) * g * g
            upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + self.eps)
            params[n] = params[n] - lr * (upd + self.wd * params[n])


def train_steps(cfg: dict, params: dict, batches: list[dict], lr: float,
                *, quant: bool = False, rows_per_pass: int = 1,
                m: dict | None = None, v: dict | None = None,
                done: int = 0) -> dict:
    """Run ``len(batches)`` steps from ``params`` (f32 copies are made) at a
    constant ``lr``, from AdamW's moments ``m`` and ``v`` after ``done``
    steps (zeros and 0 by default); the batch runs ``rows_per_pass`` rows
    at a time, its gradients summed.  Returns each step's mean loss, each
    parameter's first gradient and its norm, and each parameter's change
    norm after the steps."""
    p = {n: t.detach().to(F32).clone() for n, t in params.items()}
    start = {n: t.clone() for n, t in p.items()}
    m = {n: (torch.zeros_like(t) if m is None else m[n].to(F32).clone())
         for n, t in p.items()}
    v = {n: (torch.zeros_like(t) if v is None else v[n].to(F32).clone())
         for n, t in p.items()}
    opt, losses, first = AdamW(), [], {}
    for step, batch in enumerate(batches):
        leaves = {n: t.requires_grad_(True) for n, t in p.items()}
        count = float(batch["mask"].sum())
        total = 0.0
        B = batch["tokens"].shape[0]
        for lo in range(0, B, rows_per_pass):
            rows = {k: t[lo:lo + rows_per_pass] for k, t in batch.items()}
            part = loss_sum(cfg, leaves, rows, quant) / count
            part.backward()
            total += float(part.detach())
        grads = {n: t.grad for n, t in leaves.items()}
        if step == 0:
            first = {n: g.detach().clone() for n, g in grads.items()}
        with torch.no_grad():
            new = dict(leaves)
            opt.update(new, grads, m, v, lr, done + step)
        p = {n: t.detach() for n, t in new.items()}
        losses.append(total)
        del grads, leaves
    with torch.no_grad():
        change = {n: float((p[n] - start[n]).norm()) for n in p}
    return {"losses": losses, "grads": first,
            "grad_norms": {n: float(g.norm()) for n, g in first.items()},
            "change_norms": change}


# ------------------------------------------------------------------ serve
def prefill(cfg: dict, params: dict, prompt, *, quant: bool = False,
            on_kv=None, all_positions: bool = False):
    """Logits f32 of prompt [S]: of the last position [V], or with
    ``all_positions`` the final hidden [S, D] for the caller to unembed in
    blocks."""
    with torch.no_grad():
        h = hidden(cfg, params, prompt[None], quant=quant, on_kv=on_kv)[0]
        if all_positions:
            return h
        return mm(h[-1:], unembed_t(params), quant)[0]
