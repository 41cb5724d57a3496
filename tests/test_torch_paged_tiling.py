"""The split-S decode body in its paged layout (``csrc/dense_decode.cuh``
with PAGED: kernels B4 and B5), emulated on the CPU before any card time:
its chunk order, page segments and summation points computed in float32,
held to the JAX package's ``paged_decode_attention`` (T = 1 and 4) and
``fused_paged_decode_write`` (T = 1) in Pallas interpret mode within half
of chip_smoke.py's bound for B4 and B5 (PAGED_ATOL + PAGED_RTOL |out|).

What is emulated, beside the dense emulation of
``tests/test_torch_split_decode.py`` (whose per-warp state it reuses): each
row's window [pad, min(length, mp * ps)) is cut into NSPLIT even shares; a
split streams its share in chunks of 8 NW slots that start at the share's
first position, so a chunk crosses pages; the chunk's rows are copied page
segment by page segment, each from page ``page_table[b, pos // ps]`` (an id
outside [0, P) reads the null page 0), slot ``pos % ps``; then the warps
and splits as in the dense body, the fresh block on the last warp of the
last split. B5's fresh token goes to position ``length`` through the
table, or to page 0 outside it, quantized like ``_quantize_kv``: its page
writes are held bit-exact to the JAX kernel's outside page 0 (where the TPU
kernel drops a token past the table).
"""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_split_decode import KPW, LOG2E, _State

import chip_smoke
from llm_speech_summarization_tpu.kernels.fused_paged import fused_paged_decode_write
from llm_speech_summarization_tpu.kernels.paged_attention import paged_decode_attention
from llm_speech_summarization_tpu_torch.kernels.fused_decode import _quantize_kv, dense_splits
from llm_speech_summarization_tpu_torch.kernels.paged_attention import paged_splits

torch.set_num_threads(1)

B, HQ, HKV, DH, L, LAYER = 5, 6, 2, 128, 2, 1
MP = {128: 3, 64: 5, 16: 12}  # pages per row at each page size


def _case(kernel, T, pools, ps, seed=90):
    """Rows: a pad inside the first page and length == mp * ps (B5 writes
    page 0); a pad past the first page; nothing cached (length == pad);
    length at a page boundary; page ids of -1 and past P in the table
    beyond the window (never attended, so never read: the JAX kernel
    reads every page of the table and masks, wrapping -1 to page P - 1).
    Pools (L, P, Hkv, ps, Dh): int8 with
    bf16 scales that keep |int8 x scale| <= ~1.5, or bf16."""
    mp = MP[ps]
    P = 1 + B * mp
    rng = np.random.RandomState([seed, T, ps, pools == "int8"])
    bf = lambda a: np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)  # noqa: E731
    shape = (L, P, HKV, ps, DH)
    if pools == "int8":
        kp, vp = (rng.randint(-127, 128, size=shape).astype(np.int8) for _ in range(2))
        ks, vs = (bf(0.002 + 0.01 * rng.rand(*shape[:-1])) for _ in range(2))
    else:
        kp, vp = (bf(rng.randn(*shape)) for _ in range(2))
        ks = vs = None
    table = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    table[4, 2::2] = -1  # row 4 attends pages 0 and 1 only
    table[4, 3::2] = P + 3
    pads = np.array([3, ps + 2, 1, 0, 5], np.int32)
    lengths = np.array([mp * ps, mp * ps - 7, 1, 2 * ps, 2 * ps - 3], np.int32)
    # bf16 values held in float32: the JAX kernels then compute in float32
    q, kn, vn = (bf(rng.randn(B, T, h, DH)).astype(np.float32) for h in (HQ, HKV, HKV))
    return q, kp, vp, ks, vs, table, lengths, pads, kn, vn


def _f32(a):
    return None if a is None else torch.from_numpy(np.asarray(a).astype(np.float32))


def emulate(q, kp, vp, ks, vs, table, lengths, pads, kn, vn, nsplit, NW, write):
    """The paged split-S body's arithmetic: out (B, T, Hq, Dh), bf16-rounded,
    and, with ``write`` (B5, T = 1), the pools after the fresh token's write."""
    T = q.shape[1]
    P, ps = kp.shape[1], kp.shape[3]
    mp = table.shape[1]
    G = HQ // HKV
    R = T * G
    scale2 = DH ** -0.5 * LOG2E
    CH = KPW * NW
    k_all, v_all = _f32(kp[LAYER]), _f32(vp[LAYER])  # (P, Hkv, ps, Dh)
    ones = torch.ones(P, HKV, ps)
    ks_all = _f32(ks[LAYER]) if ks is not None else ones
    vs_all = _f32(vs[LAYER]) if vs is not None else ones
    qf, knf, vnf = _f32(q), _f32(kn), _f32(vn)
    out = torch.zeros(B, T, HQ, DH)
    for b in range(B):
        pad, c_end = max(int(pads[b]), 0), min(int(lengths[b]), mp * ps)
        n_all = max(c_end - pad, 0)
        per = -(-n_all // nsplit)
        for h in range(HKV):
            qr = qf[b, :, h * G:(h + 1) * G].reshape(R, DH)  # rows (t, g)
            total = None
            for split in range(nsplit):
                lo = pad + split * per
                hi = min(lo + per, c_end)
                warps = [_State(R, DH) for _ in range(NW)]
                if split == nsplit - 1:  # the fresh block, causal, on the last warp
                    for j in range(T):
                        s = (qr @ knf[b, j, h]) * scale2
                        ok = torch.tensor([j <= r // G for r in range(R)])
                        warps[-1].update(s[:, None], ok[:, None], vnf[b, j:j + 1, h])
                for c0 in range(lo, hi, CH):
                    n = min(CH, hi - c0)
                    # the chunk's rows and scales, one page segment at a time
                    k, v = torch.empty(n, DH), torch.empty(n, DH)
                    ksc, vsc = torch.empty(n), torch.empty(n)
                    for t in range(c0 // ps, (c0 + n - 1) // ps + 1):
                        j0, j1 = max(c0, t * ps), min(c0 + n, t * ps + ps)
                        pid = int(table[b, t])
                        pid = pid if 0 <= pid < P else 0
                        src, dst = slice(j0 - t * ps, j1 - t * ps), slice(j0 - c0, j1 - c0)
                        k[dst], v[dst] = k_all[pid, h, src], v_all[pid, h, src]
                        ksc[dst], vsc[dst] = ks_all[pid, h, src], vs_all[pid, h, src]
                    for w in range(NW):
                        j0 = w * KPW
                        if j0 >= n:
                            continue
                        sl = slice(j0, min(j0 + KPW, n))
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
            out[b, :, h * G:(h + 1) * G] = (total.acc / total.l[:, None]).reshape(T, G, DH)
    out = out.bfloat16().float()
    if not write:
        return out, None
    pools = [np.array(x) for x in (kp, vp)]
    for b in range(B):
        tw = int(lengths[b]) // ps  # floor division
        pid = int(table[b, tw]) if 0 <= tw < mp else 0
        pid = pid if 0 <= pid < P else 0
        slot = int(lengths[b]) - tw * ps
        for pool, new in zip(pools, (kn, vn)):
            x = torch.from_numpy(np.asarray(new[b, 0], np.float32))  # (Hkv, Dh)
            pool[LAYER, pid, :, slot] = _quantize_kv(x)[0].numpy() if pool.dtype == np.int8 \
                else new[b, 0]
    return out, pools


@functools.lru_cache(maxsize=None)
def _jax(kernel, T, pools, ps):
    """The JAX kernel in interpret mode on the case: out (float32 tensor)
    and, for B5, its returned k/v pools."""
    q, kp, vp, ks, vs, table, lengths, pads, kn, vn = _case(kernel, T, pools, ps)
    a = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    if kernel == "B4":
        got = paged_decode_attention(
            a(q), a(kp[LAYER]), a(vp[LAYER]), a(table), a(lengths), a(pads), a(kn), a(vn),
            k_scale=None if ks is None else a(ks[LAYER]),
            v_scale=None if vs is None else a(vs[LAYER]), interpret=True)
        return torch.from_numpy(np.asarray(got, np.float32)), None
    res = fused_paged_decode_write(
        a(q), a(kp), a(vp), a(table), a(lengths), a(pads), a(kn), a(vn), jnp.int32(LAYER),
        k_scale_layer=None if ks is None else a(ks[LAYER]),
        v_scale_layer=None if vs is None else a(vs[LAYER]), interpret=True)
    return torch.from_numpy(np.asarray(res[0], np.float32)), [np.asarray(x) for x in res[1:3]]


# (kernel, T, pools, ps): each page size with chunks that start mid-page
# (every pad but 0) and, below 128, chunks that span pages; B5 needs ps >= 32
# in the JAX kernel (its 32-slot write window)
CASES = [("B4", 4, "int8", 128), ("B4", 4, "bf16", 64), ("B4", 4, "int8", 16),
         ("B4", 1, "bf16", 128), ("B4", 1, "int8", 64), ("B5", 1, "int8", 128),
         ("B5", 1, "int8", 64), ("B5", 1, "bf16", 64)]


@pytest.mark.parametrize("NW", [8, 16])
@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("kernel,T,pools,ps", CASES)
def test_paged_emulation_within_half_the_chip_bound(kernel, T, pools, ps, nsplit, NW):
    case = _case(kernel, T, pools, ps)
    got, got_pools = emulate(*case, nsplit=nsplit, NW=NW, write=kernel == "B5")
    want, want_pools = _jax(kernel, T, pools, ps)
    bound = chip_smoke.PAGED_ATOL + chip_smoke.PAGED_RTOL * want.abs()
    ratio = ((got - want).abs() / bound).max().item()
    assert torch.isfinite(got).all()
    assert ratio <= 0.5, ratio
    if got_pools is not None:  # bit-exact outside page 0
        for g, w in zip(got_pools, want_pools):
            np.testing.assert_array_equal(g[:, 1:].view(np.uint8), w[:, 1:].view(np.uint8))


def test_paged_splits_take_the_dense_rule_at_the_table_bound(monkeypatch):
    """B4/B5 split each window as the dense kernels do, from the host-side
    bound mp * ps (132 SMs on the H100, Hkv = 8): one split at the serving
    shape (B = 16, 128 blocks), several where the batch leaves SMs idle and
    the table is long enough to pay for the merge, and a scratch only then."""
    from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod

    sms = 132
    monkeypatch.setattr(fd_mod, "sm_count", lambda index: sms)
    assert dense_splits(16, 8, 7 * 128, sms) == 1  # chip_smoke's PAGED_SHAPE
    assert dense_splits(4, 8, 7 * 128, sms) == 4
    assert dense_splits(1, 8, 19 * 16, sms) == 8  # ps 16, 19 pages: 266 slots off a block
    assert dense_splits(1, 8, 18 * 16, sms) == 1  # 252: the merge does not pay
    assert dense_splits(8, 8, 4 * 128, sms) == 2
    n, part = paged_splits(16, 4, 24, 8, 128, 7, 128, torch.device("cpu"))
    assert (n, part) == (1, None)
    n, part = paged_splits(2, 4, 24, 8, 64, 20, 128, torch.device("cpu"))
    assert n == 8 and part.shape == (2 * 8, 8, 12, 130) and part.dtype == torch.float32
