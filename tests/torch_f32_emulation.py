"""CPU emulations of the float32 CUDA kernels' arithmetic, shared by the
float32 test files (not a test module itself).

Every product of the float32 flash kernels is a chain of 3xTF32
``mma.sync`` m16n8k8 k steps (``chain``): each float32 operand split into
hi = tf32(x), rounded to nearest, and lo = x - hi, of which the tensor
cores read the top 19 bits; each k step of 8 adds lo.hi, then hi.lo, then
hi.hi into the accumulator. The tensor cores' own sum is modelled
pessimistically (Fasi, Higham, Mikaitis and Pranesh, "Numerical behavior
of NVIDIA tensor cores", 2021, for the TF32 products of the A100): the
products are exact, every addend of a block is cut toward zero to the last
of the 24 bits of the largest, and the block's sum is cut toward zero to
float32. ``passes=1`` keeps hi.hi only: single-pass TF32.

``emulate_flash_3xtf32`` is ``csrc/flash_attention_f32.cu``'s forward: k
tiles of 32 keys at Dh = 128 and 64 at Dh = 64, S = Q.K^T from zero for
each tile, O += P.V across every tile after the online softmax's alpha
rescales it, the base-2 online softmax in float32, o / max(l, 1e-30) and
lse = m ln 2 + log(max(l, 1e-30)). ``emulate_bwd_3xtf32`` is
``csrc/flash_attention_bwd_f32.cu``'s dq and dk/dv.
"""

from __future__ import annotations

import torch

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30
KSTEP = 8  # the mma's depth


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does (10
    mantissa bits, to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) of float32 ``x`` as the tensor cores read them: hi =
    tf32(x), and lo = x - hi (exact in float32) with its low 13 bits
    dropped."""
    hi = tf32(x)
    return hi, ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _cut(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` cut toward zero to a multiple of 2^e."""
    q = torch.ldexp(torch.ones_like(e, dtype=torch.float64), e)
    return torch.trunc(x / q) * q


def mma_block(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One tensor-core block sum c + sum_i a_i b_i over the last dimension
    of ``a`` and ``b`` (float64 in, a float32 value out): products exact,
    every addend cut toward zero to the 24th bit of the largest addend,
    the sum cut toward zero to float32."""
    prods = a * b
    amax = torch.maximum(c.abs(), prods.abs().amax(-1))
    e = torch.frexp(amax).exponent - 24  # the largest addend's 24th bit
    inv = torch.ldexp(torch.ones_like(amax), -e)
    # every addend is now an integer below 2^26: the float64 sum is exact
    s = torch.trunc(c * inv) + torch.trunc(prods * inv[..., None]).sum(-1)
    s = s / inv
    return _cut(s, torch.frexp(s).exponent - 24)


def mma_3xtf32(a, b, acc, block: int, passes: int = 3) -> torch.Tensor:
    """acc plus one k step, the sum over the last dimension of a_i b_i, as
    the kernel's three ``mma.sync`` calls into the accumulator: lo.hi,
    hi.lo, then hi.hi (``passes=1``: hi.hi alone). ``a`` and ``b``: (hi,
    lo) float64 operands; ``block``: the terms the tensor core sums at once
    (4 or 8)."""
    order = ((1, 0), (0, 1), (0, 0)) if passes == 3 else ((0, 0),)
    k = a[0].shape[-1]
    for ia, ib in order:
        for i0 in range(0, k, block):
            acc = mma_block(a[ia][..., i0:i0 + block], b[ib][..., i0:i0 + block], acc)
    return acc


def chain(a, b, acc, block: int, passes: int = 3) -> torch.Tensor:
    """acc + sum over the last dimension of a_i b_i as a chain of
    ``mma.sync`` k steps of 8 in order, each 3xTF32 (``passes=1``: hi.hi
    alone). ``a``, ``b``: float32 operands that broadcast against each
    other; ``acc``: float64 holding float32 values. A short last step adds
    fewer terms: the kernels' zero-filled rows add zeros."""
    pa = [x.double() for x in split(a)]
    pb = [x.double() for x in split(b)]
    for i0 in range(0, a.shape[-1], KSTEP):
        acc = mma_3xtf32([x[..., i0:i0 + KSTEP] for x in pa], [x[..., i0:i0 + KSTEP] for x in pb],
                         acc, block, passes)
    return acc


def _mask(T, starts, ends, causal, offsets):
    """(B, T queries, T keys): the key window, and the causal rule moved by
    the offsets."""
    pos = torch.arange(T)
    keys = (pos[None, :] >= starts[:, None].long()) & (pos[None, :] < ends[:, None].long())
    mask = keys[:, None, :].expand(-1, T, T)
    if causal:
        q_off, k_off = offsets or (0, 0)
        mask = mask & (pos[None, :] + k_off <= pos[:, None] + q_off)
    return mask


def emulate_flash_3xtf32(q, k, v, starts, ends, causal, offsets=None, passes=3, block=8):
    """The float32 forward's arithmetic on float32 (B, T, H, Dh) q, k, v:
    returns (out (B, T, Hq, Dh), lse (B, Hq, T)), both float32."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    BK = 64 if Dh == 64 else 32  # keys a tile
    f32 = torch.float32
    scale2 = torch.tensor(Dh ** -0.5, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    mask = _mask(T, starts, ends, causal, offsets)
    outs, lses = [], []
    for h in range(Hq):
        qh, kh, vh = q[:, :, h], k[:, :, h // G], v[:, :, h // G]  # (B, T, Dh)
        # S (B, T, T): the k steps of 8 over Dh into one accumulator
        s = chain(qh[:, :, None], kh[:, None], torch.zeros((B, T, T), dtype=torch.float64),
                  block, passes)
        s = torch.where(mask, s.to(f32) * scale2, torch.tensor(NEG, dtype=f32))
        vt = vh.transpose(1, 2)[:, None]  # (B, 1, Dh, T): a key's values along the last dim
        m = torch.full((B, T, 1), NEG, dtype=f32)
        l = torch.zeros((B, T, 1), dtype=f32)
        o = torch.zeros((B, T, Dh), dtype=f32)
        for k0 in range(0, T, BK):
            n = min(BK, T - k0)
            st = s[:, :, k0:k0 + n]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(st - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha
            # a short last step: keys past T add zeros
            o = chain(p[:, :, None], vt[..., k0:k0 + n], o.double(), block, passes).to(f32)
            m = m_new
        seen = m > NEG / 2
        den = torch.clamp(l, min=1e-30)
        outs.append(torch.where(seen, o / den, torch.zeros((), dtype=f32)))
        lses.append(torch.where(seen, m * torch.tensor(LN2, dtype=f32) + torch.log(den),
                                torch.tensor(NEG, dtype=f32))[..., 0])
    return torch.stack(outs, 2), torch.stack(lses, 1)


def emulate_bwd_3xtf32(q, k, v, g, lse, delta, starts, ends, causal, offsets=None, passes=3,
                       block=8, ds_bf16=False):
    """``csrc/flash_attention_bwd_f32.cu``'s arithmetic on float32 (B, T, H,
    Dh) q, k, v, dO = ``g`` and the forward's (B, Hq, T) lse and delta:
    returns (dq, dk, dv), float32. S = Q.K^T and dP = dO.V^T each from zero,
    a chain of 3xTF32 k steps of 8 over Dh; p = 2^(s Dh^-0.5 log2(e) - lse
    log2(e)) (one fused multiply-add, then exp2f) selected inside the mask,
    ds = p (dp - delta), in float32; dQ = dS.K a chain over the keys in
    order, dq = Dh^-0.5 dQ; dK = dS^T.Q and dV = P^T.dO chains over the
    group's heads in order and, for each, its rows in order, dk = Dh^-0.5
    dK. A step the mask empties adds zeros, which leave a sum's bits as
    they are, so the chains may start at key or row 0 where the kernels
    start at their causal frontier. ``ds_bf16``: ds rounded to bf16 before
    its products (a fault)."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    scale = torch.tensor(Dh ** -0.5, dtype=f32)
    scale2 = (scale * torch.tensor(LOG2E, dtype=f32)).double()
    mask = _mask(T, starts, ends, causal, offsets)
    zero = torch.zeros((), dtype=f32)
    dq = torch.zeros((B, T, Hq, Dh), dtype=f32)
    dk = torch.zeros((B, T, Hkv, Dh), dtype=f32)
    dv = torch.zeros((B, T, Hkv, Dh), dtype=f32)
    for hk in range(Hkv):
        kh, vh = k[:, :, hk], v[:, :, hk]  # (B, T, Dh)
        dk_acc = torch.zeros((B, T, Dh), dtype=torch.float64)
        dv_acc = torch.zeros((B, T, Dh), dtype=torch.float64)
        for h in range(hk * G, (hk + 1) * G):  # the group's heads, in order
            qh, gh = q[:, :, h], g[:, :, h]
            s = chain(qh[:, :, None], kh[:, None], torch.zeros((B, T, T), dtype=torch.float64),
                      block, passes).to(f32)
            dp = chain(gh[:, :, None], vh[:, None], torch.zeros((B, T, T), dtype=torch.float64),
                       block, passes).to(f32)
            l2 = (lse[:, h] * torch.tensor(LOG2E, dtype=f32)).double()  # in float32
            e = (s.double() * scale2 - l2[:, :, None]).to(f32)  # one fma: rounded once
            p = torch.where(mask, torch.exp2(e), zero)
            ds = p * (dp - delta[:, h, :, None])
            if ds_bf16:
                ds = ds.bfloat16().float()
            # dQ (B, T, Dh): rows of ds against K^T, the keys along the last dimension
            acc = chain(ds[:, :, None], kh.transpose(1, 2)[:, None],
                        torch.zeros((B, T, Dh), dtype=torch.float64), block, passes)
            dq[:, :, h] = acc.to(f32) * scale
            # dK, dV (B, T keys, Dh): the rows along the last dimension
            pt, dst = p.transpose(1, 2), ds.transpose(1, 2)
            dk_acc = chain(dst[:, :, None], qh.transpose(1, 2)[:, None], dk_acc, block, passes)
            dv_acc = chain(pt[:, :, None], gh.transpose(1, 2)[:, None], dv_acc, block, passes)
        dk[:, :, hk] = dk_acc.to(f32) * scale
        dv[:, :, hk] = dv_acc.to(f32)
    return dq, dk, dv
