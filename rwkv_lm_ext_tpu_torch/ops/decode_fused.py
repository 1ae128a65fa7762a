"""Fused T=1 decode glue: kernels B.10 (attention prologue), B.11 (channel-mix
prologue) and B.12 (the whole channel-mix block) of csrc/decode_fused.cu, and
their plain versions.

Counterpart of rwkv_lm_ext_tpu/ops/decode_fused.py: ``att_prep_fused`` (:159,
the Pallas kernel ``_att_prep_kernel`` at :101), ``ffn_prep_fused`` (:270,
``_ffn_prep_kernel`` :251) and ``ffn_block_fused`` (:416, ``_ffn_block_kernel``
:354), with the same arguments and output order; the plain versions repeat
``_att_prep_ref`` (:53), ``_ffn_prep_ref`` (:237) and ``_ffn_block_ref``
(:324). One difference in layout: the weights of ``ffn_block_fused`` are in
torch's (out, in) layout, as the port's ``Linear`` holds them, so nothing is
transposed per call.

Precision (the JAX kernels' contract): LayerNorm, the shift difference and the
lerp adds in fp32; the ddlerp low-rank on operands rounded to x's dtype with
fp32 accumulation; the decay low-rank on fp32 operands (the mixed ``xw`` is not
rounded first, unlike the unfused step, where it leaves K2 in x's dtype); the
returned ``xn`` is the unrounded fp32 LayerNorm row. In ``ffn_block_fused`` the
key activation is rounded to x's dtype before and after relu^2, ``kv`` and
``r`` stay fp32, and the residual is added in fp32.

B.10 has two bodies (csrc/decode_fused.cu), and ``b10_body`` picks one from
dtypes and shape alone: the cluster body (bf16 activations and parameters at
C % 128 == 0, C <= 4096, D % 8 == 0, 5D <= 384, Dd a multiple of 16 up to
128: every served width), where a thread-block cluster of ``PREP_SLICES``
blocks takes a group of rows and each block owns C / ``PREP_SLICES`` columns
of every phase, the reductions over C exchanged between the blocks and summed
in rank order; and the row-pair body (fp32, and the bf16 shapes the other
does not take).
``att_prep_sliced_plain`` is the cluster body's factoring in plain PyTorch.
B.12's bf16 products stream their weights in stages of 64 rows by 256 values
(tensor-map boxes) through a ring in shared memory, as programmatic
dependent launches, and split the value product over F into
``ffn_value_splits(C, F, sms)`` slices, added in slice order;
``ffn_block_split_plain`` is that order in plain PyTorch. B.11 (and B.12's
first launch) takes a row a block of ``ffn_prep_threads(C)`` threads, eight
values a thread, and adds the row's sums in a fixed order:
``ffn_prep_warp_order_plain`` repeats it.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. When an input requires grad the call is
differentiable: the backward recomputes through the plain version, as
``_att_prep_bwd`` (:223), ``_ffn_prep_bwd`` (:310) and ``_ffn_block_bwd``
(:499) do. The TPU wrappers' gates (B % 8, C % 512, F % 512, a VMEM row cap,
with a fall-back to the jnp composition) are not carried over: any B >= 1 runs,
and the widths each kernel needs are checked and raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib

# B.10's bodies, by the codes of csrc/decode_fused.cu
B10_BODIES = {"row_pairs": 0, "cluster": 1}
PREP_SLICES = 8        # blocks of a B.10 cluster, each owning C / PREP_SLICES columns
CLUSTER_ROWS = 8       # most rows a B.10 cluster takes
STREAM_K = 256         # k values a stage of B.12's products holds
STREAM_ROWS = 64       # weight rows a block of B.12's products owns
MAX_VALUE_SPLITS = 4   # most slices of B.12's value product
FFN_PREP_MAX_THREADS = 512   # threads of a B.11 block, eight values each


def b10_body(dtype: torch.dtype, C: int, D: int, Dd: int,
             param_dtype: torch.dtype = torch.bfloat16) -> str:
    """The body of B.10 that a call of these dtypes (activations, and the
    (C,)-shaped parameters with dw1, dw2) and shape launches."""
    if (dtype == param_dtype == torch.bfloat16 and C % (16 * PREP_SLICES) == 0
            and C // PREP_SLICES <= 512 and D > 0 and D % 8 == 0 and 5 * D <= 384
            and 0 < Dd <= 128 and Dd % 16 == 0):
        return "cluster"
    return "row_pairs"


def att_prep_cluster_rows(B: int, clusters: int = 8) -> int:
    """Rows a cluster of B.10's cluster body takes when the card runs
    ``clusters`` clusters at once (the kernel asks the card; an H100 runs
    eight of its 8-block clusters at once): one wave of clusters, at most
    CLUSTER_ROWS rows each. Rows are independent, so the grouping changes
    no value; the mirror follows it to pad the last group as the kernel
    does."""
    return min(CLUSTER_ROWS, max(1, -(-B // clusters)))


def ffn_value_splits(C: int, F: int, sms: int) -> int:
    """Slices of B.12's bf16 value product on a card of ``sms`` SMs: value and
    receptance blocks of 64 weight rows together about fill the SMs once."""
    tiles = -(-C // STREAM_ROWS)
    s = (2 * (sms - tiles) + tiles) // (2 * tiles)
    return max(1, min(MAX_VALUE_SPLITS, s, -(-F // STREAM_K)))


def _ln_shift(x, shift, ln_scale, ln_bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    xn = xn * ln_scale.float() + ln_bias.float()
    return xn, shift.float() - xn


def _dot(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b on operands rounded to ``dtype``, accumulated in fp32."""
    return a.to(dtype).float() @ b.to(dtype).float()


def att_prep_plain(
    x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay, eps: float = 1e-5
) -> Tuple[torch.Tensor, ...]:
    od = x.dtype
    xn, xx = _ln_shift(x, shift, ln_scale, ln_bias, eps)
    maas = maas.float()
    D = w2.shape[1]
    h = torch.tanh(_dot(xn + xx * maas[0], w1, od))
    xw, xk, xv, xr, xg = (
        xn + xx * (maas[1 + i] + _dot(h[:, i * D:(i + 1) * D], w2[i], od)) for i in range(5)
    )
    hw = torch.tanh(xw @ dw1.float())
    w = time_decay.float().reshape(-1) + hw @ dw2.float()
    return xr.to(od), xk.to(od), xv.to(od), xg.to(od), w, xn


def att_prep_sliced_plain(
    x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay, eps: float = 1e-5, *,
    slices: int = PREP_SLICES, rows: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """att_prep_plain in the order of B.10's cluster body: rows in groups of
    ``rows`` (default ``att_prep_cluster_rows(B)``), the last group padded by
    repeating the last row (its outputs dropped); C in ``slices`` column
    slices; the row sums of x and x^2, the partial xxx @ w1 and the partial
    xw @ dw1 taken slice by slice and added in slice order; each slice's
    expansions over its own columns."""
    od = x.dtype
    B, C = x.shape
    if C % slices:
        raise ValueError(f"C={C} is not a multiple of slices={slices}")
    R = att_prep_cluster_rows(B) if rows is None else rows
    Cs, D = C // slices, w2.shape[1]
    cols = [slice(q * Cs, (q + 1) * Cs) for q in range(slices)]
    idx = torch.arange(-(-B // R) * R, device=x.device).clamp(max=B - 1)
    xf, sh = x.float()[idx], shift.float()[idx]
    maas = maas.float()
    w1f, w2f = w1.to(od).float(), w2.to(od).float()
    dw1f, dw2f = dw1.float(), dw2.float()

    def in_order(parts):
        total = torch.zeros_like(parts[0])
        for p in parts:
            total = total + p
        return total

    s1 = in_order([xf[:, c].sum(-1, keepdim=True) for c in cols])
    s2 = in_order([(xf[:, c] * xf[:, c]).sum(-1, keepdim=True) for c in cols])
    mu = s1 / C
    rstd = torch.rsqrt(torch.clamp(s2 / C - mu * mu, min=0.0) + eps)
    xn = (xf - mu) * rstd * ln_scale.float().reshape(-1) + ln_bias.float().reshape(-1)
    xx = sh - xn
    xa = (xn + xx * maas[0]).to(od).float()
    h = torch.tanh(in_order([xa[:, c] @ w1f[c] for c in cols])).to(od).float()
    mixed = torch.empty(5, *xn.shape, device=xn.device)
    for c in cols:
        for i in range(5):
            m = h[:, i * D:(i + 1) * D] @ w2f[i][:, c]
            mixed[i][:, c] = xn[:, c] + xx[:, c] * (maas[1 + i][c] + m)
    xw, xk, xv, xr, xg = mixed
    hw = torch.tanh(in_order([xw[:, c] @ dw1f[c] for c in cols]))
    w = torch.empty_like(xn)
    for c in cols:
        w[:, c] = time_decay.float().reshape(-1)[c] + hw @ dw2f[:, c]
    return tuple(t[:B] for t in (xr.to(od), xk.to(od), xv.to(od), xg.to(od), w, xn))


def ffn_prep_plain(
    x, shift, ln_scale, ln_bias, maa_k, maa_r, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    xn, xx = _ln_shift(x, shift, ln_scale, ln_bias, eps)
    xk = xn + xx * maa_k.float().reshape(-1)
    xr = xn + xx * maa_r.float().reshape(-1)
    return xk.to(x.dtype), xr.to(x.dtype), xn


def ffn_prep_threads(C: int) -> int:
    """Threads of B.11's block for a row of C values: one a chunk of eight,
    in whole warps, at most FFN_PREP_MAX_THREADS."""
    return min(FFN_PREP_MAX_THREADS, -(-C // 256) * 32)


def ffn_prep_warp_order_plain(
    x, shift, ln_scale, ln_bias, maa_k, maa_r, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ffn_prep_plain with the row sums in B.11's order: thread t of
    ``ffn_prep_threads(C)`` owns chunks t, t + threads, ... of eight values
    and sums x and x^2 (an fma, here in fp64 and rounded once) over them in
    turn; the 32 lanes of a warp fold their sums pairwise (lane l with
    l + 16, then + 8, ... as the shuffle tree does); the warps' sums are
    added in increasing warp order. Then var = max(E[x^2] - mu^2, 0), as the
    kernel and the Pallas kernel take it."""
    B, C = x.shape
    threads = ffn_prep_threads(C)
    per = -(-C // (8 * threads))                 # chunks a thread owns
    xf = torch.zeros(B, per * threads * 8, dtype=torch.float32, device=x.device)
    xf[:, :C] = x.float()
    xf = xf.view(B, per, threads, 8)
    s = torch.zeros(B, threads, dtype=torch.float32, device=x.device)
    s2 = torch.zeros_like(s)
    for c in range(per):
        for e in range(8):
            v = xf[:, c, :, e]
            s = s + v
            s2 = (v.double() * v.double() + s2.double()).float()

    def tree(a):
        a = a.view(B, threads // 32, 32)
        while a.shape[-1] > 1:
            h = a.shape[-1] // 2
            a = a[..., :h] + a[..., h:]
        total = torch.zeros(B, dtype=torch.float32, device=x.device)
        for w in range(threads // 32):
            total = total + a[:, w, 0]
        return total[:, None]

    mu = tree(s) / C
    var = torch.clamp(tree(s2) / C - mu * mu, min=0.0)
    xn = (x.float() - mu) * torch.rsqrt(var + eps) * ln_scale.float().reshape(-1)
    xn = xn + ln_bias.float().reshape(-1)
    xx = shift.float() - xn
    xk = xn + xx * maa_k.float().reshape(-1)
    xr = xn + xx * maa_r.float().reshape(-1)
    return xk.to(x.dtype), xr.to(x.dtype), xn


def ffn_block_plain(
    x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    od = x.dtype
    xk, xr, xn = ffn_prep_plain(x, shift, ln_scale, ln_bias, maa_k, maa_r, eps)
    k = torch.relu(_dot(xk, wk.t(), od).to(od)) ** 2
    kv = _dot(k, wv.t(), od)
    r = _dot(xr, wr.t(), od)
    return (x.float() + torch.sigmoid(r) * kv).to(od), xn


def ffn_block_split_plain(
    x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr, eps: float = 1e-5, *, splits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ffn_block_plain in the order of B.12's products: k rounded to x's dtype
    before and after relu^2, the value product in ``splits`` slices of F (in
    stages of STREAM_K, the last one short where F is not a multiple of it,
    ``ceil(stages / splits)`` a slice), each an fp32
    partial, added in slice order; r in fp32; the residual in fp32, cast
    once."""
    od = x.dtype
    xk, xr, xn = ffn_prep_plain(x, shift, ln_scale, ln_bias, maa_k, maa_r, eps)
    k = torch.relu(_dot(xk, wk.t(), od).to(od)) ** 2
    F = wk.shape[0]
    stages = -(-F // STREAM_K)
    per = -(-stages // splits)
    kv = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for s in range(splits):
        b, e = (min(i * per, stages) * STREAM_K for i in (s, s + 1))
        e = min(e, F)
        kv = kv + _dot(k[:, b:e], wv[:, b:e].t(), od)
    r = _dot(xr, wr.t(), od)
    return (x.float() + torch.sigmoid(r) * kv).to(od), xn


def _check_rows(x, shift, **vectors):
    if x.dim() != 2:
        raise ValueError(f"x must be (B, C), got {tuple(x.shape)}")
    B, C = x.shape
    if shift.shape != (B, C):
        raise ValueError(f"shift must be ({B}, {C}), got {tuple(shift.shape)}")
    for name, v in vectors.items():
        if v.numel() != C:
            raise ValueError(f"{name} must hold C={C} values, got {tuple(v.shape)}")
    return B, C


def _launch_att_prep(x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay, eps=1e-5,
                     body: Optional[str] = None):
    """``body`` (a key of B10_BODIES) forces one body, for comparisons; None
    takes ``b10_body``'s."""
    B, C = _check_rows(x, shift, ln_scale=ln_scale, ln_bias=ln_bias, time_decay=time_decay)
    D, Dd = w2.shape[1], dw1.shape[1]
    if maas.shape != (6, C) or w1.shape != (C, 5 * D) or w2.shape != (5, D, C):
        raise ValueError(
            f"maas must be (6, C), w1 (C, 5D) and w2 (5, D, C); got {tuple(maas.shape)}, "
            f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    if dw1.shape != (C, Dd) or dw2.shape != (Dd, C):
        raise ValueError(f"dw1 must be (C, Dd) and dw2 (Dd, C); got {tuple(dw1.shape)}, {tuple(dw2.shape)}")
    if C % 8 or D % 8 or Dd % 8 or 5 * D > 2048 or Dd > 2048:
        raise ValueError(
            f"att_prep_fused reads 16 bytes at a time: C, D and Dd must be multiples of 8 "
            f"(and 5D, Dd at most 2048); got C={C}, D={D}, Dd={Dd}")
    shift = shift.float().contiguous()
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    (ln_scale, ln_bias, maas, dw1, dw2, time_decay), pcode = _lib.param_vectors(
        ln_scale, ln_bias, maas, dw1, dw2, time_decay)
    device = _lib.check_cuda(x=x, shift=shift, ln_scale=ln_scale, ln_bias=ln_bias, maas=maas,
                             w1=w1, w2=w2, dw1=dw1, dw2=dw2, time_decay=time_decay)
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("dw1", dw1), ("dw2", dw2),
                    ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("maas", maas),
                    ("time_decay", time_decay)):
        if t.data_ptr() % 16:
            raise ValueError(f"att_prep_fused: {name} must be 16-byte aligned")
    smem, limit = _lib.library().rwkv_att_prep_smem_bytes(C, D, Dd), _lib.smem_limit(device)
    if smem > limit:
        raise ValueError(f"att_prep_fused: C={C}, D={D}, Dd={Dd} needs {smem} B of shared "
                         f"memory; the card allows {limit}")
    if body is not None and body not in B10_BODIES:
        raise ValueError(f"att_prep_fused: body must be one of {sorted(B10_BODIES)}, not {body!r}")
    elif body == "cluster" and b10_body(x.dtype, C, D, Dd, ln_scale.dtype) != "cluster":
        raise ValueError(f"att_prep_fused: the cluster body takes bf16 activations and "
                         f"parameters at C % 128 == 0, C <= 4096, D % 8 == 0, 5D <= 384 and Dd "
                         f"a multiple of 16 up to 128; got {x.dtype} / {ln_scale.dtype}, C={C}, "
                         f"D={D}, Dd={Dd}")
    xr, xk, xv, xg = torch.empty(4, B, C, dtype=x.dtype, device=device).unbind(0)
    w, xn = torch.empty(2, B, C, dtype=torch.float32, device=device).unbind(0)
    args = (x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay, xr, xk, xv, xg, w, xn,
            B, C, D, Dd, eps, _lib.DTYPE_CODES[x.dtype], pcode)
    if body is None:      # the library's own choice, which b10_body repeats
        _lib.launch("rwkv_att_prep", device, *args)
    else:
        _lib.launch("rwkv_att_prep_body", device, *args, B10_BODIES[body])
    att_prep_fused.launches += 1
    return xr, xk, xv, xg, w, xn


def _launch_ffn_prep(x, shift, ln_scale, ln_bias, maa_k, maa_r, eps=1e-5):
    B, C = _check_rows(x, shift, ln_scale=ln_scale, ln_bias=ln_bias, maa_k=maa_k, maa_r=maa_r)
    shift = shift.float().contiguous()
    (ln_scale, ln_bias, maa_k, maa_r), pcode = _lib.param_vectors(ln_scale, ln_bias, maa_k, maa_r)
    device = _lib.check_cuda(x=x, shift=shift, ln_scale=ln_scale, ln_bias=ln_bias,
                             maa_k=maa_k, maa_r=maa_r)
    xk, xr = torch.empty(2, B, C, dtype=x.dtype, device=device).unbind(0)
    xn = torch.empty(B, C, dtype=torch.float32, device=device)
    _lib.launch("rwkv_ffn_prep", device, x, shift, ln_scale, ln_bias, maa_k, maa_r, xk, xr, xn,
                B, C, eps, _lib.DTYPE_CODES[x.dtype], pcode)
    ffn_prep_fused.launches += 1
    return xk, xr, xn


def _launch_ffn_block(x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr, eps=1e-5):
    B, C = _check_rows(x, shift, ln_scale=ln_scale, ln_bias=ln_bias, maa_k=maa_k, maa_r=maa_r)
    F = wk.shape[0]
    if wk.shape != (F, C) or wv.shape != (C, F) or wr.shape != (C, C):
        raise ValueError(
            f"weights are (out, in): wk (F, C), wv (C, F), wr (C, C); got {tuple(wk.shape)}, "
            f"{tuple(wv.shape)}, {tuple(wr.shape)}")
    if C % 32 or F % 32:
        raise ValueError(f"ffn_block_fused takes C and F in multiples of 32 (one k chunk of "
                         f"its products); got C={C}, F={F}")
    shift = shift.float().contiguous()
    wk, wv, wr = (w.to(x.dtype).contiguous() for w in (wk, wv, wr))
    (ln_scale, ln_bias, maa_k, maa_r), pcode = _lib.param_vectors(ln_scale, ln_bias, maa_k, maa_r)
    device = _lib.check_cuda(x=x, shift=shift, ln_scale=ln_scale, ln_bias=ln_bias, maa_k=maa_k,
                             maa_r=maa_r, wk=wk, wv=wv, wr=wr)
    for name, t in (("x", x), ("wk", wk), ("wv", wv), ("wr", wr)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    code = _lib.DTYPE_CODES[x.dtype]
    slices = _lib.library().rwkv_ffn_block_slices(code)
    out, xk, xr = torch.empty(3, B, C, dtype=x.dtype, device=device).unbind(0)
    k = torch.empty(B, F, dtype=x.dtype, device=device)
    xn = torch.empty(B, C, dtype=torch.float32, device=device)
    partials = torch.empty(slices + 1, B, C, dtype=torch.float32, device=device)
    _lib.launch("rwkv_ffn_block", device, x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr,
                out, xn, xk, xr, k, partials, B, C, F, eps, code, pcode)
    ffn_block_fused.launches += 1
    return out, xn


def _route(launch, plain, tensors, eps):
    if tensors[0].device.type == "cpu":
        return plain(*tensors, eps)
    if _lib.needs_grad(*tensors):
        return _lib.recompute_backward(launch, plain, tensors, eps=eps)
    return launch(*tensors, eps)


def att_prep_fused(
    x: torch.Tensor,
    shift: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    maas: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    dw1: torch.Tensor,
    dw2: torch.Tensor,
    time_decay: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """The attention prologue of one decode step.

    x (B, C), the raw residual stream; shift (B, C), the previous ln1 row
    (run in fp32); ln_scale, ln_bias, time_decay: C values each; maas (6, C)
    stacked [maa_x, maa_w, maa_k, maa_v, maa_r, maa_g]; w1 (C, 5D), w2
    (5, D, C), used in x's dtype; dw1 (C, Dd), dw2 (Dd, C), used in fp32.

    Returns xr, xk, xv, xg (B, C) in x's dtype, w (B, C) fp32, the raw
    log-decay, and xn (B, C) fp32, the ln1 output: the next shift row. CPU
    tensors take the plain version; CUDA tensors launch B.10 (the body
    ``b10_body`` names), for any B and C, D, Dd in multiples of 8."""
    args = (x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay)
    return _route(_launch_att_prep, att_prep_plain, args, eps)


def ffn_prep_fused(
    x: torch.Tensor,
    shift: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    maa_k: torch.Tensor,
    maa_r: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The channel-mix prologue: ln2 + token shift + the k and r mixes.
    Returns xk, xr (B, C) in x's dtype and xn (B, C) fp32, the next ffn
    shift. CPU tensors take the plain version; CUDA tensors launch B.11, for
    any B and C."""
    args = (x, shift, ln_scale, ln_bias, maa_k, maa_r)
    return _route(_launch_ffn_prep, ffn_prep_plain, args, eps)


def ffn_block_fused(
    x: torch.Tensor,
    shift: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    maa_k: torch.Tensor,
    maa_r: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wr: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole channel-mix block of one decode step: ln2 + token shift +
    mixes + key (F, C) + relu^2 + value (C, F) + receptance (C, C) + the
    sigmoid-gated residual. Weights in torch's (out, in) layout, used in x's
    dtype. Returns (x + ffn_out (B, C) in x's dtype, xn (B, C) fp32, the next
    ffn shift). CPU tensors take the plain version; CUDA tensors launch
    B.12 (one wrapper call, four kernels in stream order, the last three as
    dependent launches), for any B and C, F in multiples of 32."""
    args = (x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr)
    return _route(_launch_ffn_block, ffn_block_plain, args, eps)


att_prep_fused.launches = 0
ffn_prep_fused.launches = 0
ffn_block_fused.launches = 0
