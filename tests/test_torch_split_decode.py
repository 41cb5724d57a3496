"""The split-S dense decode body (``csrc/dense_decode.cuh``, kernels B2, B3
and B8), emulated on the CPU before any card time: its tile order and
summation points computed in float32, held to the JAX package's B2
(``fused_decode_aliased_scales`` in Pallas interpret mode, float32) within
half of chip_smoke.py's float32 bound for the dense decode kernels
(PAGED_ATOL + PAGED_RTOL |out|).

What is emulated: each (sample, kv head) window [pad, offset) is cut into
NSPLIT even shares; a split streams its share in chunks of 8 NW slots, and
each of its NW warps (8 or 16, by the grid) takes 8 keys of every chunk in
order, keeping its own
base-2 online softmax (running max, sum and float32 accumulator; the
scores times the slot's k scale, p times the slot's v scale); the last
warp of the last split takes the fresh block first, causally; the warps are
merged in warp order, the splits in split order, and the output is rounded
to bf16. A split or warp with no key keeps max -1e30 and sum 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llm_speech_summarization_tpu.kernels.fused_decode import _pad128, fused_decode_aliased_scales
from llm_speech_summarization_tpu_torch.kernels.fused_decode import dense_splits

torch.set_num_threads(1)

NEG = -1e30
LOG2E = 1.4426950408889634
KPW = 8  # keys of a chunk per consumer warp


def _case(seed, T, B=4, Hq=6, Hkv=2, S=256, Dh=128, L=2):
    """Rows: the whole cache (offset S - T); nothing cached (offset 0); one
    slot, so that every split but the first is empty; an uneven window."""
    rng = np.random.RandomState(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    q, kn, vn = (bf(rng.randn(B, T, h, Dh)) for h in (Hq, Hkv, Hkv))
    kc, vc = (rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8) for _ in range(2))
    ks, vs = (bf(0.002 + 0.01 * rng.rand(L, B, Hkv, S)) for _ in range(2))
    pads = np.array([0, 0, 150, 3], np.int32)
    offs = np.array([S - T, 0, 151, 200], np.int32)
    return q, kc, vc, ks, vs, kn, vn, pads, offs


class _State:
    """A warp's (or split's) running max, sum and accumulator per row."""

    def __init__(self, R, Dh):
        self.m = torch.full((R,), NEG)
        self.l = torch.zeros(R)
        self.acc = torch.zeros(R, Dh)

    def update(self, s, ok, v):
        """Keys with base-2 scores s (R, n), valid where ok, values v (n, Dh)
        (already times p's per-slot weight through `v`)."""
        mx = torch.where(ok, s, torch.tensor(NEG)).amax(-1)
        m_new = torch.maximum(self.m, mx)
        alpha = torch.exp2(self.m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new[:, None]), torch.zeros(()))
        self.l = self.l * alpha + p.sum(-1)
        self.acc = self.acc * alpha[:, None] + p @ v
        self.m = m_new

    def merge(self, other):
        M = torch.maximum(self.m, other.m)
        w0, w1 = torch.exp2(self.m - M), torch.exp2(other.m - M)
        self.l = self.l * w0 + other.l * w1
        self.acc = self.acc * w0[:, None] + other.acc * w1[:, None]
        self.m = M


def emulate(q, kc, vc, ks, vs, kn, vn, pads, offs, layer, nsplit, NW):
    """The split-S body's arithmetic: out (B, T, Hq, Dh), bf16-rounded."""
    B, T, Hq, Dh = q.shape
    Hkv = kc.shape[2]
    G = Hq // Hkv
    R = T * G
    scale2 = Dh ** -0.5 * LOG2E
    CH = KPW * NW
    out = torch.zeros(B, T, Hq, Dh)
    for b in range(B):
        pad, c_end = max(int(pads[b]), 0), min(int(offs[b]), kc.shape[3])
        n_all = max(c_end - pad, 0)
        per = -(-n_all // nsplit)
        for h in range(Hkv):
            qr = torch.from_numpy(q[b, :, h * G:(h + 1) * G]).reshape(R, Dh)  # rows (t, g)
            k = torch.from_numpy(kc[layer, b, h].astype(np.float32))
            v = torch.from_numpy(vc[layer, b, h].astype(np.float32))
            ksc, vsc = (torch.from_numpy(x[layer, b, h]) for x in (ks, vs))
            total = None
            for split in range(nsplit):
                lo = pad + split * per
                hi = min(lo + per, c_end)
                warps = [_State(R, Dh) for _ in range(NW)]
                if split == nsplit - 1:  # the fresh block, causal, on the last warp
                    kf = torch.from_numpy(kn[b, :, h])
                    vf = torch.from_numpy(vn[b, :, h])
                    for j in range(T):
                        s = (qr @ kf[j]) * scale2
                        ok = torch.tensor([j <= r // G for r in range(R)])
                        warps[-1].update(s[:, None], ok[:, None], vf[j:j + 1])
                for c0 in range(lo, hi, CH):
                    n = min(CH, hi - c0)
                    for w in range(NW):
                        j0 = w * KPW
                        if j0 >= n:
                            continue
                        sl = slice(c0 + j0, c0 + min(j0 + KPW, n))
                        s = (qr @ k[sl].T) * (ksc[sl] * scale2)
                        ok = torch.ones_like(s, dtype=torch.bool)
                        warps[w].update(s, ok, v[sl] * vsc[sl][:, None])
                block = warps[0]
                for w in warps[1:]:
                    block.merge(w)
                if total is None:
                    total = block
                else:
                    total.merge(block)
            o = (total.acc / total.l[:, None]).reshape(T, G, Dh)
            out[b, :, h * G:(h + 1) * G] = o
    return out.bfloat16().float()


def _jax_b2(q, kc, vc, ks, vs, kn, vn, pads, offs, layer):
    S = kc.shape[3]
    Spad = _pad128(S)
    pad_s = lambda a: jnp.zeros(a.shape[:-1] + (Spad,), jnp.float32).at[..., :S].set(a)  # noqa: E731
    want = fused_decode_aliased_scales(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pads), jnp.asarray(offs), jnp.int32(layer), pad_s(ks).astype(jnp.bfloat16),
        pad_s(vs).astype(jnp.bfloat16), interpret=True)
    return torch.from_numpy(np.array(want[0], np.float32))


@pytest.mark.parametrize("NW", [8, 16])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("nsplit", [1, 2, 3])
def test_split_decode_emulation_within_half_the_chip_bound(nsplit, T, NW):
    case = _case(80 + T, T)
    got = emulate(*case, layer=1, nsplit=nsplit, NW=NW)
    want = _jax_b2(*case, layer=1)
    bound = chip_smoke.PAGED_ATOL + chip_smoke.PAGED_RTOL * want.abs()
    ratio = ((got - want).abs() / bound).max().item()
    assert torch.isfinite(got).all()
    assert ratio <= 0.5, ratio


def test_dense_splits_take_only_idle_sms():
    """As many splits as keep the grid within one block an SM (132 on the
    H100), at most 8, and one where that takes fewer than 256 slots off
    each block's path."""
    assert dense_splits(16, 8, 383, 132) == 1  # 128 blocks
    assert dense_splits(128, 8, 383, 132) == 1
    assert dense_splits(8, 8, 511, 132) == 1  # 2 splits would save 255 slots
    assert dense_splits(8, 8, 512, 132) == 2  # 128 blocks
    assert dense_splits(4, 8, 383, 132) == 4
    assert dense_splits(4, 8, 255, 132) == 1
    assert dense_splits(1, 8, 2000, 132) == 8
    assert dense_splits(1, 8, 300, 132) == 8  # 262 slots off each block
    assert dense_splits(1, 8, 292, 132) == 1
    assert dense_splits(2, 2, 0, 132) == 1  # nothing cached
    assert dense_splits(1, 8, 2000, 16) == 2  # a smaller card
