"""Fused WKV + GroupNorm(ln_x) + gate: kernel K1 (csrc/wkv_fused.cu), its
backward B.6 + B.7 (csrc/wkv_fused_bwd.cu), and their plain versions.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_pallas.py: ``wkv6_fused_output``
(:1068, the Pallas kernel ``_wkv_gn_kernel`` at :743) with its custom_vjp
(``_wkv_fused``, :910-942, whose backward ``_fused_bwd_pallas`` at :945 runs
``_wkv_gn_fwd_save_kernel`` and ``_wkv_gn_bwd_kernel``), and, as the plain
version, ``_fused_ref`` (:823): the sequential ``wkv_reference`` followed by
the per-head GroupNorm, scale/bias and gate.

K1 has two bodies (csrc/wkv_fused.cu), and ``k1_body`` picks one from the
dtype alone: bf16 runs chunks of 16 steps with the products on the tensor
cores, fp32 the sequential recurrence on fp32 FMAs. The chunked body scales
r and k inside a chunk only by ``exp`` of sums of ``-exp(w)``, never of a
positive number, so like the recurrence it is exact at any decay
(``wkv6_fused_output_chunked_plain`` is its factoring in plain PyTorch). The
JAX package's chunked kernel needed an exact-A or midpoint-rescale factoring
of each chunk, chosen per checkpoint by ``cfg.wkv_exact``/``fused_chunk`` and
``suggest_/apply_/verify_wkv_dispatch`` (models/rwkv.py:74-164). The port
has nothing for that dispatch to select, so it has none. The backward is
sequential (two passes, see csrc/wkv_fused_bwd.cu).

On a CUDA tensor the forward is a ``torch.autograd.Function`` when grad
mode is on and an input requires grad (training), and a direct K1 launch
otherwise (serving). The initial state may be (B, H, N, N), or (H, N, N)
shared by every sequence (state tuning's ``time_state``), whose gradient is
then the sum over B.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib
from rwkv_lm_ext_tpu_torch.ops.wkv_reference import wkv_reference

HEAD_SIZES = (32, 64)
# K1's bodies, by the codes of csrc/wkv_fused.cu
K1_BODIES = {"sequential": 0, "chunked": 1}


def k1_body(dtype: torch.dtype) -> str:
    """The body of K1 that a call on r, k, v, g of this dtype launches."""
    return "chunked" if dtype == torch.bfloat16 else "sequential"


def wkv6_fused_output_plain(
    r, k, v, w, u, g, ln_scale, ln_bias, initial_state=None, *, eps: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, H, N = r.shape
    if initial_state is not None and initial_state.dim() == 3:
        initial_state = initial_state.expand(B, H, N, N)
    y, sT = wkv_reference(r, k, v, w, u, initial_state)
    return _group_norm_gate(y, g, ln_scale, ln_bias, eps), sT


def _group_norm_gate(y, g, ln_scale, ln_bias, eps):
    """y: (B, T, H, N) fp32 -> the gated, normalised (B, T, H*N) in g's dtype."""
    B, T, H, N = y.shape
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = ((y - mu) * torch.rsqrt(var + eps)).reshape(B, T, H * N)
    out = (yn * ln_scale.float() + ln_bias.float()) * g.reshape(B, T, H * N).float()
    return out.to(g.dtype)


def wkv6_fused_output_chunked_plain(
    r, k, v, w, u, g, ln_scale, ln_bias, initial_state=None, *, eps: float, chunk: int = 16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """wkv6_fused_output_plain by the factoring of K1's chunked body, in fp32
    (the kernel's two-limb bf16 operands are not mirrored). Per chunk of
    ``chunk`` steps (any length; the last chunk may be shorter), with
    d = -exp(w), c_t = d_0 + .. + d_{t-1} and c_L the chunk's total:

      y_t = (r_t exp(c_t)) @ S + sum_{s<t} A[t, s] v_s + (r_t . u k_t) v_t
      A[t, s] = sum_i r_ti k_si exp(c_t,i - c_{s+1},i)
      S <- diag(exp(c_L)) S + sum_s (k_s exp(c_L - c_{s+1}))^T v_s

    No exponent is positive, so nothing overflows at any decay. For the tests
    and the card checks; no model path calls it."""
    B, T, H, N = r.shape
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, not {chunk}")
    rf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (r, k, v))      # (B, H, T, N)
    d = -torch.exp(w.float()).permute(0, 2, 1, 3)
    uf = u.float()
    if initial_state is None:
        S = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    else:
        S = initial_state.float().expand(B, H, N, N)
    ys = []
    for t0 in range(0, T, chunk):
        rc, kc, vc, dc = (t[:, :, t0:t0 + chunk] for t in (rf, kf, vf, d))
        L = rc.shape[2]
        zero = torch.zeros_like(dc[:, :, :1])
        cc = torch.cat([zero, torch.cumsum(dc, dim=2)], dim=2)            # cc[t] = c_t, L + 1 rows
        # c_L - c_{s+1} as a backward sum of d, which does not cancel
        back = torch.cumsum(torch.flip(dc, [2]), dim=2)
        suf = torch.flip(torch.cat([zero, back[:, :, :-1]], dim=2), [2])
        y = torch.einsum("bhti,bhij->bhtj", rc * torch.exp(cc[:, :, :L]), S)
        below = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)     # s < t
        diff = cc[:, :, :L, None, :] - cc[:, :, None, 1:, :]              # c_t - c_{s+1}
        diff = torch.where(below[:, :, None], diff, torch.zeros_like(diff))
        A = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * torch.exp(diff)).sum(-1) * below
        A = A + torch.diag_embed(torch.einsum("bhti,hi,bhti->bht", rc, uf, kc))
        ys.append(y + A @ vc)
        S = torch.exp(cc[:, :, L])[..., None] * S + torch.einsum(
            "bhsi,bhsj->bhij", kc * torch.exp(suf), vc)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3) if ys else rf.permute(0, 2, 1, 3)
    return _group_norm_gate(y, g, ln_scale, ln_bias, eps), S.contiguous()


def wkv6_fused_output_bwd_plain(
    r, k, v, w, u, g, ln_scale, ln_bias, initial_state, dout, dsT, *, eps: float
) -> Tuple[Optional[torch.Tensor], ...]:
    """(dr, dk, dv, dw, du, ds0, dg, dln_scale, dln_bias) of the plain
    forward by torch.autograd.grad, for the cotangents dout (of the gated
    output) and dsT (of the final state); None for either is zeros. ds0 is
    None when initial_state is None."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u, g, ln_scale, ln_bias)]
        if initial_state is not None:
            leaves.append(initial_state.detach().requires_grad_())
        out, sT = wkv6_fused_output_plain(*leaves[:8], leaves[8] if len(leaves) > 8 else None,
                                          eps=eps)
        pairs = [(o, ct) for o, ct in ((out, dout), (sT, dsT)) if ct is not None]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], leaves, [ct for _, ct in pairs], allow_unused=True
        ) if pairs else [None] * len(leaves)
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves, grads)]
    dr, dk, dv, dw, du, dg, dsc, dbi = grads[:8]
    ds0 = grads[8] if initial_state is not None else None
    return dr, dk, dv, dw, du, ds0, dg, dsc, dbi


def _prepare(r, k, v, w, u, g, ln_scale, ln_bias, initial_state):
    """Check the inputs of the CUDA route and cast them as the kernels take
    them: w, u, ln_scale, ln_bias and the (B, H, N, N) initial state in
    fp32. Returns the kernels' arguments after r, k, v."""
    B, T, H, N = r.shape
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not supported by K1 (one of {HEAD_SIZES})")
    for name, t in (("k", k), ("v", v), ("w", w), ("g", g)):
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("g", g)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
    if u.shape != (H, N) or ln_scale.shape != (H * N,) or ln_bias.shape != (H * N,):
        raise ValueError("u must be (H, N) and ln_scale/ln_bias (H*N,)")
    if initial_state is None:
        s0 = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    elif initial_state.shape == (B, H, N, N):
        s0 = initial_state.float().contiguous()
    elif initial_state.shape == (H, N, N):
        s0 = initial_state.float().expand(B, H, N, N).contiguous()
    else:
        raise ValueError(f"initial_state must be {(B, H, N, N)} or {(H, N, N)}")
    return (w.float().contiguous(), u.float().contiguous(), g,
            ln_scale.float().contiguous(), ln_bias.float().contiguous(), s0)


def _launch_k1(r, k, v, w, u, g, ln_scale, ln_bias, s0, eps, body=None):
    """``body`` (a key of K1_BODIES) overrides k1_body's choice: the card
    checks time one body beside the other; no caller in the package sets it."""
    B, T, H, N = r.shape
    device = _lib.check_cuda(
        r=r, k=k, v=v, w=w, u=u, g=g, ln_scale=ln_scale, ln_bias=ln_bias, s0=s0
    )
    out = torch.empty(B, T, H * N, dtype=g.dtype, device=device)
    sT = torch.empty(B, H, N, N, dtype=torch.float32, device=device)
    _lib.launch(
        "rwkv_wkv6_fused", device, r, k, v, w, u, g, ln_scale, ln_bias, s0,
        out, sT, B, T, H, N, eps, _lib.DTYPE_CODES[r.dtype],
        K1_BODIES[body or k1_body(r.dtype)],
    )
    wkv6_fused_output.launches += 1
    return out, sT


def wkv6_bwd_forward_pass(r, k, v, w, u, g, ln_scale, ln_bias, s0, dout, dsT, eps):
    """B.6: K1's forward run again inside the backward, with the
    GroupNorm/gate adjoint. Takes the kernels' argument types (see
    _prepare; dout (B, T, H*N) in g's dtype and dsT (B, H, N, N) fp32, each
    may be None). Returns dy (B, T, H, N) fp32, dr' (B, T, H, N) fp64, dg in
    g's dtype, the (B, H*N) partials of dln_scale and dln_bias, and c_T
    (B, H, N) fp64."""
    B, T, H, N = r.shape
    device = _lib.check_cuda(r=r, k=k, v=v, w=w, u=u, g=g, ln_scale=ln_scale,
                             ln_bias=ln_bias, s0=s0,
                             **{n: t for n, t in (("dout", dout), ("dsT", dsT)) if t is not None})
    f32 = dict(dtype=torch.float32, device=device)
    dy = torch.empty(B, T, H, N, **f32)
    drp = torch.empty(B, T, H, N, dtype=torch.float64, device=device)
    dg = torch.empty(B, T, H, N, dtype=g.dtype, device=device)
    dsc_p, dbi_p = torch.empty(B, H * N, **f32), torch.empty(B, H * N, **f32)
    cT = torch.empty(B, H, N, dtype=torch.float64, device=device)
    _lib.launch(
        "rwkv_wkv6_bwd_forward", device, r, k, v, w, u, g, ln_scale, ln_bias, s0, dout,
        dsT, dy, drp, dg, dsc_p, dbi_p, cT, B, T, H, N, eps, _lib.DTYPE_CODES[r.dtype],
    )
    wkv6_bwd_forward_pass.launches += 1
    return dy, drp, dg, dsc_p, dbi_p, cT


def wkv6_bwd_reverse_pass(r, k, v, w, u, dy, drp, cT, dsT, *, lengths=None, reverse=False):
    """B.7: the reverse-time adjoint. Returns dr, dk, dv (r's dtype), dw
    (fp32), the (B, H, N) partials of du and ds0 (B, H, N, N). ``u`` may be
    None (no bonus). ``lengths`` ((B,) int32, or None) and ``reverse`` are
    the unfused WKV's walk over each row's valid prefix (ops/wkv.py); K1's
    backward leaves them out."""
    B, T, H, N = r.shape
    device = _lib.check_cuda(r=r, k=k, v=v, w=w, dy=dy, **{
        n: t for n, t in (("u", u), ("dsT", dsT)) if t is not None})
    for name, t in (("drp", drp), ("cT", cT)):   # B.6's fp64 outputs
        if t.dtype != torch.float64 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp64 tensor on {device}")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=device)
    dw = torch.empty(B, T, H, N, **f32)
    du_p = torch.empty(B, H, N, **f32)
    ds0 = torch.empty(B, H, N, N, **f32)
    _lib.launch(
        "rwkv_wkv6_bwd_reverse", device, r, k, v, w, u, dy, drp, cT, dsT, lengths,
        dr, dk, dv, dw, du_p, ds0, B, T, H, N, int(reverse), _lib.DTYPE_CODES[r.dtype],
    )
    wkv6_bwd_reverse_pass.launches += 1
    return dr, dk, dv, dw, du_p, ds0


def wkv6_fused_output_bwd(
    r, k, v, w, u, g, ln_scale, ln_bias, initial_state, dout, dsT, *, eps: float
) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of wkv6_fused_output: the tuple of
    wkv6_fused_output_bwd_plain, in fp32 for dw, du, ds0, dln_scale and
    dln_bias and in the inputs' dtype for dr, dk, dv and dg. CPU tensors
    take the plain version; CUDA tensors launch B.6 then B.7, and reduce
    the per-(b, h) partials in a fixed order."""
    if r.device.type == "cpu":
        return wkv6_fused_output_bwd_plain(
            r, k, v, w, u, g, ln_scale, ln_bias, initial_state, dout, dsT, eps=eps
        )
    B, T, H, N = r.shape
    w32, u32, g, sc, bi, s0 = _prepare(r, k, v, w, u, g, ln_scale, ln_bias, initial_state)
    if dout is not None:
        if dout.shape != (B, T, H * N):
            raise ValueError(f"dout must be {(B, T, H * N)}")
        dout = dout.to(g.dtype).contiguous()
    if dsT is not None:
        if dsT.shape != (B, H, N, N):
            raise ValueError(f"dsT must be {(B, H, N, N)}")
        dsT = dsT.float().contiguous()
    dy, drp, dg, dsc_p, dbi_p, cT = wkv6_bwd_forward_pass(
        r, k, v, w32, u32, g, sc, bi, s0, dout, dsT, eps)
    dr, dk, dv, dw, du_p, ds0 = wkv6_bwd_reverse_pass(r, k, v, w32, u32, dy, drp, cT, dsT)
    if initial_state is None:
        ds0 = None
    elif initial_state.dim() == 3:
        ds0 = _lib.sum_partials(ds0)
    return (dr, dk, dv, dw, _lib.sum_partials(du_p), ds0, dg,
            _lib.sum_partials(dsc_p), _lib.sum_partials(dbi_p))


class _WkvFused(torch.autograd.Function):
    """K1 forward, B.6 + B.7 backward. Saves only the primal inputs, as
    ``_fused_fwd`` does (wkv_pallas.py:918-923); casts happen inside, so a
    checkpointed recompute sees the same inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, g, ln_scale, ln_bias, initial_state, eps):
        ctx.set_materialize_grads(False)
        ctx.eps = eps
        ctx.save_for_backward(r, k, v, w, u, g, ln_scale, ln_bias, initial_state)
        return _launch_k1(r, k, v, *_prepare(r, k, v, w, u, g, ln_scale, ln_bias, initial_state),
                          eps)

    @staticmethod
    def backward(ctx, dout, dsT):
        saved = ctx.saved_tensors
        if dout is None and dsT is None:
            return (None,) * 10
        dr, dk, dv, dw, du, ds0, dg, dsc, dbi = wkv6_fused_output_bwd(
            *saved, dout, dsT, eps=ctx.eps)
        grads = (dr, dk, dv, dw, du, dg, dsc, dbi, ds0)
        return tuple(
            gr.to(t.dtype) if need and gr is not None else None
            for gr, t, need in zip(grads, saved, ctx.needs_input_grad)
        ) + (None,)


def wkv6_fused_output(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    g: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
    *,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, g: (B, T, H, N), one dtype; w: (B, T, H, N) log-decay (run
    in fp32); u: (H, N); ln_scale/ln_bias: (H*N,); initial_state:
    (B, H, N, N) or (H, N, N) fp32, or None. Returns the gated output
    (B, T, H*N) in g's dtype, ready for the output projection, and the final
    state (B, H, N, N) fp32. CPU tensors take the plain version; CUDA
    tensors launch K1, for any T and N in HEAD_SIZES, differentiable
    through B.6 + B.7 when an input requires grad."""
    if r.device.type == "cpu":
        return wkv6_fused_output_plain(
            r, k, v, w, u, g, ln_scale, ln_bias, initial_state, eps=eps
        )
    args = (r, k, v, w, u, g, ln_scale, ln_bias, initial_state)
    if _lib.needs_grad(*args):
        return _WkvFused.apply(*args, eps)
    return _launch_k1(r, k, v, *_prepare(*args), eps)


wkv6_fused_output.launches = 0
wkv6_bwd_forward_pass.launches = 0
wkv6_bwd_reverse_pass.launches = 0
