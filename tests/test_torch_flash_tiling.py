"""The wgmma flash kernels' tiling, emulated on the CPU before any card time:
the forward (B1, B1 + LSE, B7), dq and dk/dv (B6, B7) computed in float32 in
the kernels' tile order and at their rounding points, held to the JAX
package's Pallas kernels in interpret mode (``_flash_impl`` and
``_flash_bwd_impl``, float32) with chip_smoke.py's bounds.

What is emulated (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/flash_attention_bwd_dkv.cu``):
- forward: 64-row q tiles over k tiles of 64 keys (Dh=128) or 128 (Dh=64);
  scores pre-scaled by scale * log2(e), masked to -1e30, a base-2 online
  softmax, p rounded to bf16 before P.V, the output rounded to bf16; the lse
  is m ln 2 + log(l), and a row that sees no key writes zeros and -1e30;
- dq: 64-row q tiles over k tiles of 64 keys in order; p = 2^(s scale
  log2 e - lse log2 e), 0 where masked (by selection); ds = p (dp - delta)
  rounded to bf16 before dQ += dS.K; dq times the scale, rounded to bf16;
- dk/dv: 128-key tiles over (q head of the group, 64-row q tile) steps in
  that order; p = 2^(s scale log2 e - lse log2 e),
  0 where masked; p and ds = p (dp - delta) rounded to bf16 before dV +=
  P^T.dO and dK += dS^T.Q; dk times the scale, both rounded to bf16.
Every case must stay under half of the lse, the flat B1 and the dk/dv
bounds. The scaled output bound (B7_OUT_*) has no such margin: bf16's unit
roundoff is 2^-8, so the two roundings it covers (p before P.V, the output)
can each take up to 2^-8 of their term, which is the whole bound; rows that
see a few keys come to 0.5-0.72 of it here, so a case must stay under it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llm_speech_summarization_tpu.kernels.flash_attention import _flash_bwd_impl, _flash_impl

torch.set_num_threads(1)

NEG = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
FWD_BK = {64: 128, 128: 64}  # keys per k tile of the forward, by Dh
DQ_BK = 64  # keys per k tile of dq
BQ = 64  # q rows per forward tile and per dk/dv step (each key row of dk/dv
# sums its steps on its own, so the size of a key tile changes nothing)

CASES = {
    # causal GQA 4/2 with left pads (one reaching past the first tiles)
    "causal_gqa_leftpad": dict(T=200, Hq=4, Hkv=2, causal=True, starts=[0, 71],
                               ends=[200, 200], offsets=None),
    # bidirectional with right pads, one window a single key
    "bidir_rightpad": dict(T=190, Hq=4, Hkv=4, causal=False, starts=[0, 0], ends=[190, 1],
                           offsets=None),
    # offset mode (the ring interior): the causal frontier moved by
    # q_off - k_off = 37 keys, mid-tile
    "offset_frontier_midtile": dict(T=160, Hq=4, Hkv=2, causal=True, starts=[0, 21],
                                    ends=[160, 160], offsets=(37, 0)),
}
PARAMS = [(name, dh) for name in CASES for dh in (64, 128)]


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float()


def _case(name, Dh, seed=0):
    c = CASES[name]
    rng = np.random.RandomState(seed)
    B, T, Hq, Hkv = 2, c["T"], c["Hq"], c["Hkv"]
    q, k, v, g = (_bf16(rng.randn(*s).astype(np.float32))
                  for s in ((B, T, Hq, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh), (B, T, Hq, Dh)))
    return c, q, k, v, g, torch.tensor(c["starts"]), torch.tensor(c["ends"])


def _mask(c, T, starts, ends):
    """(B, 1, T, S) keys each query sees."""
    pos = torch.arange(T)
    keys = (pos[None, :] >= starts[:, None]) & (pos[None, :] < ends[:, None])
    mask = keys[:, None, None, :].expand(-1, 1, T, T)
    if c["causal"]:
        q_off, k_off = c["offsets"] or (0, 0)
        mask = mask & (pos[None, :] + k_off <= pos[:, None] + q_off)[None, None]
    return mask


def emulate_fwd(c, q, k, v, starts, ends):
    """The forward kernel's arithmetic, tile by tile: (out, lse)."""
    B, T, Hq, Dh = q.shape
    G = Hq // k.shape[2]
    BK = FWD_BK[Dh]
    kr, vr = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))  # (B, Hq, T, Dh)
    qt = q.transpose(1, 2)
    mask = _mask(c, T, starts, ends)
    scale2 = Dh ** -0.5 * LOG2E
    m = torch.full((B, Hq, T, 1), NEG)
    l = torch.zeros((B, Hq, T, 1))
    o = torch.zeros((B, Hq, T, Dh))
    for k0 in range(0, T, BK):
        sl = slice(k0, min(k0 + BK, T))
        s = torch.where(mask[..., sl], (qt @ kr[:, :, sl].transpose(-1, -2)) * scale2,
                        torch.tensor(NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ vr[:, :, sl]
        m = m_new
    seen = m > NEG / 2
    out = torch.where(seen, o / l, torch.zeros(())).bfloat16().float().transpose(1, 2)
    lse = torch.where(seen, m * LN2 + torch.log(l), torch.tensor(NEG))[..., 0]
    return out, lse


def emulate_dkv(c, q, k, v, g, lse, delta, starts, ends):
    """The dk/dv kernel's arithmetic, step by step: (dk, dv)."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    mask = _mask(c, T, starts, ends)[:, 0]  # (B, T query, S key)
    scale = Dh ** -0.5
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # (B, Hkv, S, Dh)
    dk = torch.zeros((B, Hkv, T, Dh))
    dv = torch.zeros((B, Hkv, T, Dh))
    for gi in range(G):
        heads = torch.arange(Hkv) * G + gi
        qh, gh = q[:, :, heads].transpose(1, 2), g[:, :, heads].transpose(1, 2)
        lse2 = lse[:, heads] * LOG2E  # (B, Hkv, T)
        dl = delta[:, heads]
        for q0 in range(0, T, BQ):
            sl = slice(q0, min(q0 + BQ, T))
            st = kt @ qh[:, :, sl].transpose(-1, -2)  # (B, Hkv, S, q)
            ok = mask[:, sl].transpose(-1, -2)[:, None]  # (B, 1, S, q)
            p = torch.where(ok, torch.exp2(st * (scale * LOG2E) - lse2[:, :, None, sl]),
                            torch.zeros(()))
            dpt = vt @ gh[:, :, sl].transpose(-1, -2)
            ds = p * (dpt - dl[:, :, None, sl])
            dv = dv + p.bfloat16().float() @ gh[:, :, sl]
            dk = dk + ds.bfloat16().float() @ qh[:, :, sl]
    return ((dk * scale).bfloat16().float().transpose(1, 2),
            dv.bfloat16().float().transpose(1, 2))


def emulate_dq(c, q, k, v, g, lse, delta, starts, ends):
    """The dq kernel's arithmetic, k tile by k tile: dq (B, T, Hq, Dh)."""
    B, T, Hq, Dh = q.shape
    G = Hq // k.shape[2]
    kr, vr = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))  # (B, Hq, T, Dh)
    qt, gt = q.transpose(1, 2), g.transpose(1, 2)
    mask = _mask(c, T, starts, ends)
    scale = Dh ** -0.5
    lse2 = (lse * LOG2E)[..., None]  # (B, Hq, T, 1)
    dq = torch.zeros((B, Hq, T, Dh))
    for k0 in range(0, T, DQ_BK):
        sl = slice(k0, min(k0 + DQ_BK, T))
        s = qt @ kr[:, :, sl].transpose(-1, -2)
        p = torch.where(mask[..., sl], torch.exp2(s * (scale * LOG2E) - lse2), torch.zeros(()))
        dp = gt @ vr[:, :, sl].transpose(-1, -2)
        ds = p * (dp - delta[..., None])
        dq = dq + ds.bfloat16().float() @ kr[:, :, sl]
    return (dq * scale).bfloat16().float().transpose(1, 2)


def _jax_fwd(c, q, k, v, starts, ends):
    B, T, Hq, _ = q.shape
    args = [jnp.asarray(x.numpy()) for x in (q, k, v, starts.int(), ends.int())]
    out, lse = _flash_impl(*args, c["causal"], T, T, True, return_lse=True,
                           offsets=c["offsets"])
    return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse).reshape(B, Hq, T))


@pytest.mark.parametrize("name,Dh", PARAMS)
def test_forward_tiling_within_the_chip_bounds(name, Dh):
    c, q, k, v, _, starts, ends = _case(name, Dh)
    out, lse = emulate_fwd(c, q, k, v, starts, ends)
    ref_out, ref_lse = _jax_fwd(c, q, k, v, starts, ends)
    abs_out = _jax_fwd(c, q, k, v.abs(), starts, ends)[0]  # (P.|V|) / l
    seen = ref_lse > -1e29  # (B, Hq, T)
    rows = seen.transpose(1, 2)  # (B, T, Hq)
    assert (lse[~seen] == NEG).all() and (out.transpose(1, 2)[~seen] == 0).all()
    lse_ratio = ((lse - ref_lse).abs() / (chip_smoke.LSE_ATOL
                                          + chip_smoke.LSE_RTOL * ref_lse.abs()))[seen].max()
    bound = chip_smoke.B7_OUT_ATOL + chip_smoke.B7_OUT_RTOL * (ref_out.abs() + abs_out)
    out_ratio = ((out - ref_out).abs() / bound).amax(-1)[rows].max()
    out_err = (out - ref_out).abs().amax(-1)[rows].max()
    assert lse_ratio <= 0.5, lse_ratio
    assert out_ratio <= 1, out_ratio  # the worst case of two bf16 roundings (docstring)
    assert out_err <= chip_smoke.B1_TOL / 2, out_err


def _row_ratio(got, ref):
    bound = (chip_smoke.BWD_RTOL * ref.abs()
             + chip_smoke.BWD_ATOL * ref.pow(2).mean(-1, keepdim=True).sqrt()
             + chip_smoke.BWD_FLOOR * ref.pow(2).mean().sqrt() + 1e-12)
    return ((got - ref).abs() / bound).max().item()


@pytest.mark.parametrize("name,Dh", PARAMS)
def test_dkv_tiling_within_half_the_chip_bounds(name, Dh):
    c, q, k, v, g, starts, ends = _case(name, Dh, seed=1)
    out, lse = emulate_fwd(c, q, k, v, starts, ends)
    delta = (g * out).sum(-1).transpose(1, 2)  # (B, Hq, T), as the wrapper computes it
    dk, dv = emulate_dkv(c, q, k, v, g, lse, delta, starts, ends)
    B, T, Hq, _ = q.shape
    args = [jnp.asarray(x.numpy()) for x in (q, k, v, out)]
    _, ref_dk, ref_dv = _flash_bwd_impl(
        *args, jnp.asarray(lse.numpy().reshape(B * Hq, 1, T)), jnp.asarray(g.numpy()),
        jnp.asarray(starts.int().numpy()), jnp.asarray(ends.int().numpy()), c["causal"], T, T,
        True, offsets=c["offsets"])
    for what, got, ref in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        ratio = _row_ratio(got, torch.from_numpy(np.array(ref)))
        assert ratio <= 0.5, (what, ratio)


@pytest.mark.parametrize("name,Dh", PARAMS)
def test_dq_tiling_within_half_the_chip_bounds(name, Dh):
    c, q, k, v, g, starts, ends = _case(name, Dh, seed=2)
    out, lse = emulate_fwd(c, q, k, v, starts, ends)
    delta = (g * out).sum(-1).transpose(1, 2)  # (B, Hq, T), as the wrapper computes it
    dq = emulate_dq(c, q, k, v, g, lse, delta, starts, ends)
    B, T, Hq, _ = q.shape
    args = [jnp.asarray(x.numpy()) for x in (q, k, v, out)]
    ref_dq = _flash_bwd_impl(
        *args, jnp.asarray(lse.numpy().reshape(B * Hq, 1, T)), jnp.asarray(g.numpy()),
        jnp.asarray(starts.int().numpy()), jnp.asarray(ends.int().numpy()), c["causal"], T, T,
        True, offsets=c["offsets"])[0]
    ref = torch.from_numpy(np.array(ref_dq))
    pos = torch.arange(T)
    rows = (pos[None, :] >= starts[:, None]) & (pos[None, :] < ends[:, None])  # (B, T)
    # chip_smoke's _row_ratio on the valid query rows (its floor from their RMS)
    bound = (chip_smoke.BWD_RTOL * ref.abs()
             + chip_smoke.BWD_ATOL * ref.pow(2).mean(-1, keepdim=True).sqrt()
             + chip_smoke.BWD_FLOOR * ref[rows].pow(2).mean().sqrt() + 1e-12)
    ratio = ((dq - ref).abs() / bound)[rows].max().item()
    assert ratio <= 0.5, ratio
