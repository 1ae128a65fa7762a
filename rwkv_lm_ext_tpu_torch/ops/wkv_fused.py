"""Fused WKV + GroupNorm(ln_x) + gate: kernel K1 (csrc/wkv_fused.cu), its
backward B.6 + B.7 (csrc/wkv_fused_bwd.cu), and their plain versions.

Counterpart of rwkv_lm_ext_tpu/ops/wkv_pallas.py: ``wkv6_fused_output``
(:1068, the Pallas kernel ``_wkv_gn_kernel`` at :743) with its custom_vjp
(``_wkv_fused``, :910-942, whose backward ``_fused_bwd_pallas`` at :945 runs
``_wkv_gn_fwd_save_kernel`` and ``_wkv_gn_bwd_kernel``), and, as the plain
version, ``_fused_ref`` (:823): the sequential ``wkv_reference`` followed by
the per-head GroupNorm, scale/bias and gate.

K1 has two bodies (csrc/wkv_fused.cu), and ``k1_body`` picks one from the
dtype and head size: bf16 at N of 32 or 64 runs chunks of 16 steps with the
products on the tensor cores, fp32 (and N of 16 or 128) the sequential
recurrence on fp32 FMAs. The chunked body scales
r and k inside a chunk only by ``exp`` of sums of ``-exp(w)``, never of a
positive number, so like the recurrence it is exact at any decay
(``wkv6_fused_output_chunked_plain`` is its factoring in plain PyTorch). The
JAX package's chunked kernel needed an exact-A or midpoint-rescale factoring
of each chunk, chosen per checkpoint by ``cfg.wkv_exact``/``fused_chunk`` and
``suggest_/apply_/verify_wkv_dispatch`` (models/rwkv.py:74-164). The port
has nothing for that dispatch to select, so it has none.

The backward (B.6 then B.7, csrc/wkv_fused_bwd.cu) has two bodies too, and
``wkv_bwd_body`` picks one by K1's rule: bf16 at N of 32 or 64 runs K1's
chunk factoring on the tensor cores (pass 1 keeps the state at every chunk's
entry, pass 2 walks the chunks in reverse), fp32 and N of 16 or 128 the
sequential fp64 recurrences. ``wkv6_fused_output_bwd_chunked_plain`` is the chunked
body's factoring in plain PyTorch. The passes hand each other a
``BwdCarry``; each pass is one launch, and ``body=`` on pass 1 (and on
``wkv6_fused_output_bwd``) forces a body for the card checks.

On a CUDA tensor the forward is a ``torch.autograd.Function`` when grad
mode is on and an input requires grad (training), and a direct K1 launch
otherwise (serving). The initial state may be (B, H, N, N), or (H, N, N)
shared by every sequence (state tuning's ``time_state``), whose gradient is
then the sum over B.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rwkv_lm_ext_tpu_torch.ops import _lib
from rwkv_lm_ext_tpu_torch.ops.wkv_reference import wkv_reference

HEAD_SIZES = (16, 32, 64, 128)
# the head sizes of the chunked bodies (K1, B.6, B.7); the others (16 and
# 128) run the sequential ones
CHUNKED_HEAD_SIZES = (32, 64)
# K1's bodies, by the codes of csrc/wkv_fused.cu
K1_BODIES = {"sequential": 0, "chunked": 1}
WKV_BWD_BODIES = ("sequential", "chunked")


def k1_body(dtype: torch.dtype, N: int = 64) -> str:
    """The body of K1 that a call on r, k, v, g of this dtype and head size
    launches."""
    return "chunked" if dtype == torch.bfloat16 and N in CHUNKED_HEAD_SIZES else "sequential"


def wkv_bwd_body(dtype: torch.dtype, N: int) -> str:
    """The body of both passes of the WKV backward (B.6 or its gn=False form,
    then B.7) that a call on r, k, v of this dtype and head size launches:
    bf16 the chunked tensor-core bodies, fp32 the sequential fp64 ones: the
    choice K1 makes."""
    return k1_body(dtype, N)


def check_head_size(N: int, what: str) -> None:
    """Raise for a head size the WKV kernels do not take. N = 128 runs the
    sequential bodies, whose backward keeps its (N, N + 1) tile in dynamic
    shared memory (132 KB in fp64 at N = 128)."""
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not supported by {what} (one of {HEAD_SIZES})")


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
    """wkv6_fused_output_plain by the factoring of K1's chunked body
    (``_wkv_chunked``), in fp32 (the kernel's two-limb bf16 operands are not
    mirrored), then the GroupNorm and gate. For the tests and the card
    checks; no model path calls it."""
    B, T, H, N = r.shape
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, not {chunk}")
    rf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (r, k, v))      # (B, H, T, N)
    d = -torch.exp(w.float()).permute(0, 2, 1, 3)
    if initial_state is None:
        S = torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
    else:
        S = initial_state.float().expand(B, H, N, N)
    y, S, _ = _wkv_chunked(rf, kf, vf, d, u.float(), S, chunk)
    return _group_norm_gate(y.permute(0, 2, 1, 3), g, ln_scale, ln_bias, eps), S.contiguous()


def _wkv_chunked(r, k, v, d, u, S, chunk):
    """The chunked forward of the WKV recurrence on (B, H, T, N) operands
    (d = -exp(w); steps to leave out have d = 0 and r = k = v = 0), in their
    dtype, any chunk length (the last chunk may be shorter). Per chunk, with
    c_t = d_0 + .. + d_{t-1} and c_L the chunk's total (_chunk_decays):

      y_t = (r_t exp(c_t)) @ S + sum_{s<t} A[t, s] v_s + (r_t . u k_t) v_t
      A[t, s] = sum_i r_ti k_si exp(c_t,i - c_{s+1},i)
      S <- diag(exp(c_L)) S + sum_s (k_s exp(c_L - c_{s+1}))^T v_s

    No exponent is positive, so nothing overflows at any decay. The
    factoring of the chunked bodies of K1, B.6's pass 1 and B.8. Returns y
    (B, H, T, N), the final state and the list of chunk-entry states."""
    ys, states = [], []
    for t0 in range(0, r.shape[2], chunk):
        rc, kc, vc, dc = (x[:, :, t0:t0 + chunk] for x in (r, k, v, d))
        e_in, e_out, e_L, M = _chunk_decays(dc)
        A = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, M)
        A = A + torch.diag_embed(torch.einsum("bhti,hi,bhti->bht", rc, u, kc))
        ys.append(torch.einsum("bhti,bhij->bhtj", rc * e_in, S) + A @ vc)
        states.append(S)
        S = e_L[..., None] * S + torch.einsum("bhsi,bhsj->bhij", kc * e_out, vc)
    y = torch.cat(ys, 2) if ys else torch.zeros_like(r)
    return y, S, states


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


def _chunk_decays(d):
    """Per chunk (..., L, N) of d = -exp(w): exp(c_t) with c_t = d_0 + ..
    + d_{t-1}, exp(c_L - c_{t+1}) (the decay from after step t to the
    chunk's end), exp(c_L), and M[t, s] = exp(c_t - c_{s+1}) for s < t (the
    decay from after step s to before step t; 0 elsewhere), (..., L, L, N).
    No exponent is positive."""
    L = d.shape[-2]
    zero = torch.zeros_like(d[..., :1, :])
    cc = torch.cat([zero, torch.cumsum(d, dim=-2)], dim=-2)             # c_0 .. c_L
    back = torch.cumsum(torch.flip(d, [-2]), dim=-2)
    cout = torch.flip(torch.cat([zero, back[..., :-1, :]], dim=-2), [-2])
    below = torch.ones(L, L, dtype=torch.bool, device=d.device).tril(-1)
    diff = cc[..., :L, None, :] - cc[..., None, 1:, :]
    M = torch.where(below[:, :, None], torch.exp(torch.where(below[:, :, None], diff, 0.0)), 0.0)
    return torch.exp(cc[..., :L, :]), torch.exp(cout), torch.exp(cc[..., L, :]), M


def _wkv_bwd_chunked(r, k, v, d, u, dy, s0, dsT, chunk, entry_states=None):
    """The chunked backward of the WKV recurrence on (B, H, T, N) operands
    (d = -exp(w); steps to leave out have d = 0 and r = k = v = dy = 0), in
    their dtype: pass 1 keeps the state at every chunk's entry (or takes
    ``entry_states``), pass 2 walks the chunks in reverse with the adjoint
    state dS. Per chunk, with exp(c) of _chunk_decays and the scores
    B[t, s] = dy_t . v_s:

      dr'_t = e^{c_t} (S_in dy_t) + sum_{s<t} M[t,s] k_s B[t,s]
      dk'_s = e^{c_L-c_{s+1}} (dS_out v_s) + sum_{t>s} M[t,s] r_t B[t,s]
      dv'_t = (k_t e^{c_L-c_{t+1}}) dS_out + sum_{s>t} A[s,t] dy_s
      dS_in = e^{c_L} dS_out + sum_t (r_t e^{c_t})^T dy_t
      dL/dd_m = e^{c_L} X + sum_{s<m} k_s dk'^out_s + sum_{t>m} r_t dr'^in_t
                + sum_{s<m<t} M[t,s] r_t k_s B[t,s]

    with A the forward's scores, X[i] = sum_j dS_out[i,j] S_in[i,j], and
    dk'^out, dr'^in the first terms of dk', dr'. Every term of dL/dd_m holds
    the decay of step m, so nothing cancels where that decay is tiny (the
    sequential identity dL/dd_m = c_T + sum r dr' - sum k dk' cancels to the
    last bit there). Returns dr, dk, dv (bonus terms added), dL/dd, du and
    ds0."""
    B, H, T, N = r.shape
    S = s0.clone()
    if entry_states is None:
        entry_states = []
        for t0 in range(0, T, chunk):
            kc, vc, dc = (x[:, :, t0:t0 + chunk] for x in (k, v, d))
            _, e_out, e_L, _ = _chunk_decays(dc)
            entry_states.append(S)
            S = e_L[..., None] * S + torch.einsum("bhsi,bhsj->bhij", kc * e_out, vc)
    dS = dsT.clone()
    dr, dk, dv, dd = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros_like(r[:, :, 0])
    for n in reversed(range(len(entry_states))):
        t0 = n * chunk
        sl = slice(t0, t0 + chunk)
        rc, kc, vc, dc, dyc = (x[:, :, sl] for x in (r, k, v, d, dy))
        S_in = entry_states[n]
        e_in, e_out, e_L, M = _chunk_decays(dc)
        Bs = dyc @ vc.transpose(-1, -2)                                   # B[t, s]
        A = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, M)
        drp_in = e_in * torch.einsum("bhij,bhtj->bhti", S_in, dyc)
        dkp_out = e_out * torch.einsum("bhij,bhsj->bhsi", dS, vc)
        W = M * Bs[..., None]                                             # (b, h, t, s, i)
        drp = drp_in + torch.einsum("bhtsi,bhsi->bhti", W, kc)
        dkp = dkp_out + torch.einsum("bhtsi,bhti->bhsi", W, rc)
        dvp = torch.einsum("bhti,bhij->bhtj", kc * e_out, dS) + A.transpose(-1, -2) @ dyc
        vdy = torch.diagonal(Bs, dim1=-2, dim2=-1)[..., None]             # (b, h, t, 1)
        ruk = (rc * u[None, :, None] * kc).sum(-1, keepdim=True)
        dr[:, :, sl] = drp + u[None, :, None] * kc * vdy
        dk[:, :, sl] = dkp + rc * u[None, :, None] * vdy
        dv[:, :, sl] = dvp + dyc * ruk
        du += (rc * kc * vdy).sum(2)
        L = rc.shape[2]
        idx = torch.arange(L, device=r.device)
        straddle = ((idx[None, None, :] < idx[:, None, None])
                    & (idx[None, :, None] > idx[:, None, None])).to(r.dtype)   # [m, t, s]: s<m<t
        G = torch.einsum("mts,bhtsi,bhti,bhsi->bhmi", straddle, W, rc, kc)
        kd_out, rd_in = kc * dkp_out, rc * drp_in
        before = torch.cumsum(kd_out, 2) - kd_out                          # sum over s < m
        after = torch.flip(torch.cumsum(torch.flip(rd_in, [2]), 2), [2]) - rd_in   # over t > m
        X = (dS * S_in).sum(-1)
        dd[:, :, sl] = (e_L * X)[:, :, None] + before + after + G
        dS = e_L[..., None] * dS + torch.einsum("bhti,bhtj->bhij", rc * e_in, dyc)
    return dr, dk, dv, dd, du.sum(0), dS


def _group_norm_gate_bwd(y, g, ln_scale, ln_bias, dout, eps):
    """The adjoint of _group_norm_gate at y (B, T, H, N) for the cotangent
    dout (B, T, H*N), as B.6 applies it row by row: (dy, dg, dln_scale,
    dln_bias), all in y's dtype."""
    B, T, H, N = y.shape
    sc, bi = (x.to(y.dtype).reshape(H, N) for x in (ln_scale, ln_bias))
    dout = dout.to(y.dtype).reshape(B, T, H, N)
    gf = g.to(y.dtype).reshape(B, T, H, N)
    mu = y.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((y - mu) ** 2).mean(-1, keepdim=True) + eps)
    z = (y - mu) * rstd
    dpre = dout * gf
    dz = dpre * sc
    dy = rstd * (dz - dz.mean(-1, keepdim=True) - z * (dz * z).mean(-1, keepdim=True))
    return (dy, dout * (z * sc + bi), (dpre * z).sum((0, 1)).reshape(H * N),
            dpre.sum((0, 1)).reshape(H * N))


def wkv6_fused_output_bwd_chunked_plain(
    r, k, v, w, u, g, ln_scale, ln_bias, initial_state, dout, dsT, *, eps: float,
    chunk: int = 16,
) -> Tuple[Optional[torch.Tensor], ...]:
    """wkv6_fused_output_bwd_plain by the factoring of the chunked bodies of
    B.6 and B.7 (csrc/wkv_fused_bwd.cu), in fp64, any chunk length: pass 1
    runs K1's chunked forward (``_wkv_chunked``) keeping
    the state at every chunk's entry and applies the GroupNorm/gate adjoint
    row by row; pass 2 is _wkv_bwd_chunked. The same tuple, in fp32 (dr, dk,
    dv, dg too). For the tests and the card checks; no model path calls it."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, not {chunk}")
    B, T, H, N = r.shape
    f64 = torch.float64
    rf, kf, vf = (x.to(f64).permute(0, 2, 1, 3) for x in (r, k, v))
    d = -torch.exp(w.to(f64)).permute(0, 2, 1, 3)
    uf = u.to(f64)
    s0 = (torch.zeros(B, H, N, N, dtype=f64) if initial_state is None
          else initial_state.to(f64).expand(B, H, N, N))
    # pass 1: y by K1's factoring, and the state at each chunk's entry
    y, _, states = _wkv_chunked(rf, kf, vf, d, uf, s0, chunk)
    y = y.permute(0, 2, 1, 3)
    if dout is None:
        dy, dg = torch.zeros_like(y), torch.zeros_like(y)
        dsc = dbi = torch.zeros(H * N, dtype=f64)
    else:
        dy, dg, dsc, dbi = _group_norm_gate_bwd(y, g, ln_scale, ln_bias, dout, eps)
    dST = torch.zeros(B, H, N, N, dtype=f64) if dsT is None else dsT.to(f64)
    dr, dk, dv, dd, du, ds0 = _wkv_bwd_chunked(
        rf, kf, vf, d, uf, dy.permute(0, 2, 1, 3), s0, dST, chunk, entry_states=states)
    back = lambda x: x.permute(0, 2, 1, 3).float()
    if initial_state is None:
        ds0 = None
    elif initial_state.dim() == 3:
        ds0 = ds0.sum(0)
    return (back(dr), back(dk), back(dv), back(dd * d), du.float(),
            None if ds0 is None else ds0.float(), dg.reshape(g.shape).float(),
            dsc.float(), dbi.float())


def _prepare(r, k, v, w, u, g, ln_scale, ln_bias, initial_state):
    """Check the inputs of the CUDA route and cast them as the kernels take
    them: w, u, ln_scale, ln_bias and the (B, H, N, N) initial state in
    fp32. Returns the kernels' arguments after r, k, v."""
    B, T, H, N = r.shape
    check_head_size(N, "K1")
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
        K1_BODIES[body or k1_body(r.dtype, N)],
    )
    wkv6_fused_output.launches += 1
    return out, sT


class BwdCarry(NamedTuple):
    """What pass 1 of the WKV backward hands pass 2, by the body that ran it:
    sequential, dr' (B, T, H, N) and c_T (B, H, N) fp64; chunked, the state
    at every chunk's entry (B*H, ceil(T / chunk), N, N) fp32."""
    body: str
    drp: Optional[torch.Tensor] = None
    cT: Optional[torch.Tensor] = None
    states: Optional[torch.Tensor] = None


def _bwd_pass1_body(r, body):
    B, T, H, N = r.shape
    body = body or wkv_bwd_body(r.dtype, N)
    if body not in WKV_BWD_BODIES:
        raise ValueError(f"body must be one of {WKV_BWD_BODIES}, not {body!r}")
    if body == "chunked" and (r.dtype != torch.bfloat16 or N not in CHUNKED_HEAD_SIZES):
        raise ValueError(f"the chunked body takes bf16 and N in {CHUNKED_HEAD_SIZES}, "
                         f"not {r.dtype} and N={N}")
    return body


def _entry_states(B, T, H, N, device):
    chunk = _lib.library().rwkv_wkv6_fused_chunk()
    return torch.empty(B * H, (T + chunk - 1) // chunk, N, N, dtype=torch.float32, device=device)


def wkv6_bwd_forward_pass(r, k, v, w, u, g, ln_scale, ln_bias, s0, dout, dsT, eps, body=None):
    """B.6: K1's forward run again inside the backward, with the
    GroupNorm/gate adjoint. Takes the kernels' argument types (see
    _prepare; dout (B, T, H*N) in g's dtype and dsT (B, H, N, N) fp32, each
    may be None). Returns dy (B, T, H, N) fp32, dg in g's dtype, the
    (B, H*N) partials of dln_scale and dln_bias, and the BwdCarry for pass 2.
    ``body`` overrides wkv_bwd_body's choice (the card checks time one body
    beside the other; no caller in the package sets it)."""
    B, T, H, N = r.shape
    body = _bwd_pass1_body(r, body)
    device = _lib.check_cuda(r=r, k=k, v=v, w=w, u=u, g=g, ln_scale=ln_scale,
                             ln_bias=ln_bias, s0=s0,
                             **{n: t for n, t in (("dout", dout), ("dsT", dsT)) if t is not None})
    f32 = dict(dtype=torch.float32, device=device)
    dy = torch.empty(B, T, H, N, **f32)
    dg = torch.empty(B, T, H, N, dtype=g.dtype, device=device)
    dsc_p, dbi_p = torch.empty(B, H * N, **f32), torch.empty(B, H * N, **f32)
    if body == "chunked":
        carry = BwdCarry(body, states=_entry_states(B, T, H, N, device))
        _lib.launch(
            "rwkv_wkv6_bwd_forward_chunked", device, r, k, v, w, u, g, ln_scale, ln_bias, s0,
            dout, carry.states, dy, dg, dsc_p, dbi_p, B, T, H, N, eps,
        )
    else:
        carry = BwdCarry(body, drp=torch.empty(B, T, H, N, dtype=torch.float64, device=device),
                         cT=torch.empty(B, H, N, dtype=torch.float64, device=device))
        _lib.launch(
            "rwkv_wkv6_bwd_forward", device, r, k, v, w, u, g, ln_scale, ln_bias, s0, dout,
            dsT, dy, carry.drp, dg, dsc_p, dbi_p, carry.cT, B, T, H, N, eps,
            _lib.DTYPE_CODES[r.dtype],
        )
    wkv6_bwd_forward_pass.launches += 1
    return dy, dg, dsc_p, dbi_p, carry


def wkv6_bwd_reverse_pass(r, k, v, w, u, dy, carry, dsT, *, lengths=None, reverse=False):
    """B.7: the reverse-time adjoint, by the body of pass 1 that made
    ``carry``. Returns dr, dk, dv (r's dtype), dw (fp32), the (B, H, N)
    partials of du and ds0 (B, H, N, N). ``u`` may be None (no bonus).
    ``lengths`` ((B,) int32, or None) and ``reverse`` are the unfused WKV's
    walk over each row's valid prefix (ops/wkv.py); K1's backward leaves
    them out."""
    B, T, H, N = r.shape
    device = _lib.check_cuda(r=r, k=k, v=v, w=w, dy=dy, **{
        n: t for n, t in (("u", u), ("dsT", dsT)) if t is not None})
    if carry.body == "chunked":
        want = {"states": (carry.states, torch.float32)}
    else:
        want = {"drp": (carry.drp, torch.float64), "cT": (carry.cT, torch.float64)}
    for name, (t, dtype) in want.items():
        if t is None or t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} of a {carry.body} pass 1 must be a contiguous {dtype} "
                             f"tensor on {device}")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=device)
    dw = torch.empty(B, T, H, N, **f32)
    du_p = torch.empty(B, H, N, **f32)
    ds0 = torch.empty(B, H, N, N, **f32)
    if carry.body == "chunked":
        _lib.launch(
            "rwkv_wkv6_bwd_reverse_chunked", device, r, k, v, w, u, dy, carry.states, dsT,
            lengths, dr, dk, dv, dw, du_p, ds0, B, T, H, N, int(reverse),
        )
    else:
        _lib.launch(
            "rwkv_wkv6_bwd_reverse", device, r, k, v, w, u, dy, carry.drp, carry.cT, dsT,
            lengths, dr, dk, dv, dw, du_p, ds0, B, T, H, N, int(reverse),
            _lib.DTYPE_CODES[r.dtype],
        )
    wkv6_bwd_reverse_pass.launches += 1
    return dr, dk, dv, dw, du_p, ds0


def wkv6_fused_output_bwd(
    r, k, v, w, u, g, ln_scale, ln_bias, initial_state, dout, dsT, *, eps: float, body=None
) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of wkv6_fused_output: the tuple of
    wkv6_fused_output_bwd_plain, in fp32 for dw, du, ds0, dln_scale and
    dln_bias and in the inputs' dtype for dr, dk, dv and dg. CPU tensors
    take the plain version; CUDA tensors launch B.6 then B.7 (the body of
    wkv_bwd_body, or ``body``), and reduce the per-(b, h) partials in a
    fixed order."""
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
    dy, dg, dsc_p, dbi_p, carry = wkv6_bwd_forward_pass(
        r, k, v, w32, u32, g, sc, bi, s0, dout, dsT, eps, body=body)
    dr, dk, dv, dw, du_p, ds0 = wkv6_bwd_reverse_pass(r, k, v, w32, u32, dy, carry, dsT)
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
