"""Flash attention: the forward (kernel B1), its log-sum-exp variant and the
FlashAttention-2 backward (kernel B6: dq and dk/dv), with their plain
versions, launch counts and the differentiable ``flash_attention``; and
their offset mode (kernel B7), the per-block interior of ring attention
(``ops/ring_attention.py``).

Port of ``llm_speech_summarization_tpu/kernels/flash_attention.py``. The
CUDA kernels are ``csrc/flash_attention.cu`` (forward, optionally writing
the log-sum-exp), ``csrc/flash_attention_bwd.cu`` (dq) and
``csrc/flash_attention_bwd_dkv.cu`` (dk/dv summed over the GQA group); the
forward, dq and dk/dv are wgmma + TMA designs over ``csrc/flash_sm90.cuh``.
Their header notes say what bounds them on the H100 and how each design
meets that. TMA reads q/k/v/dout through a tensor map, so each
needs a 16-byte aligned base and (b, t, h) strides that are positive
multiples of 8 elements; the wrappers raise on any other view.

q (B, T, Hq, Dh); k, v (B, T, Hkv, Dh); starts/ends (B,) int32: sample b's
valid keys are [start_b, end_b), causal means query i sees keys j <= i.
Queries outside the window produce finite garbage rows that callers mask
downstream (the JAX contract). The log-sum-exp is float32 (B, Hq, T); a
row with no valid key gets -1e30, as the TPU kernel writes. CPU tensors
take the plain versions; CUDA tensors launch the kernels, and any shape,
dtype or layout the kernels do not take raises.

Every entry point has a float32 instance, for models the JAX package runs
in float32 (its kernels are dtype-generic: at float32 operands nothing in
them rounds below float32), each with its own launch count:
``flash_attention_fwd_f32`` (B1 alone: the HuBERT-CTC model and the
teacher's no-grad forward) and ``flash_attention_fwd_lse_f32`` (B1 + LSE)
in ``csrc/flash_attention_f32.cu`` (3xTF32 ``mma.sync`` products over a
cp.async ring), ``flash_attention_bwd_dq_f32`` and
``flash_attention_bwd_dkv_f32`` (B6) in ``csrc/flash_attention_bwd_f32.cu``
(3xTF32 ``mma.sync`` products over a cp.async ring, the GQA group summed
in the block), each in its own library, and B7's
``*_offset_f32``. Every entry point routes CUDA tensors by dtype: bfloat16
to the bf16 kernel, float32 to its float32 instance; float16 and mixed
dtypes raise, naming what is ported. ``FlashAttention`` and the ring's
interior (``ops/ring_attention.py``) thus train in float32 through the
same calls.

Offset mode (B7): ``flash_attention_fwd_lse_offset``,
``flash_attention_bwd_dq_offset`` and ``flash_attention_bwd_dkv_offset``
take ``offsets`` = (q_off, k_off), two host ints that place the queries and
the keys of one call at those global positions; the causal rule becomes
``k + k_off <= q + q_off`` (the TPU kernels' scalar-prefetched offsets). A
row that sees no key of the block gets lse = -1e30. They count their
launches apart from B1 and B6.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.attention import NEG_INF, dot_product_attention, make_attention_bias
from .build import check_status, count_launch, load_library

SOURCES = ("flash_attention.cu", "flash_sm90.cuh")
BWD_SOURCES = ("flash_attention_bwd.cu", "flash_sm90.cuh")
DKV_SOURCES = ("flash_attention_bwd_dkv.cu", "flash_sm90.cuh")
F32_SOURCES = ("flash_attention_f32.cu", "flash_f32.cuh")
BWD_F32_SOURCES = ("flash_attention_bwd_f32.cu", "flash_f32.cuh")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: dense masked attention over the same windows
    (the JAX package's ``_xla_reference``)."""
    T = q.shape[1]
    pos = torch.arange(T, dtype=torch.int32, device=q.device)[None, :]
    valid = (pos >= starts[:, None]) & (pos < ends[:, None])
    bias = make_attention_bias(valid, valid, causal=causal)
    return dot_product_attention(q, k, v, bias)


def _masked_scores(q, k, starts, ends, causal, offsets=None):
    """float32 (float64 for float64 q) scores (B, Hkv, G, T, S) = scale *
    q.k^T and the key mask (B, 1, 1, T, S) of the window and the causal
    rule, shifted by ``offsets`` = (q_off, k_off) when given."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, T, Hkv, Hq // Hkv, Dh).to(acc)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.to(acc)) * Dh ** -0.5
    pos = torch.arange(T, dtype=torch.int32, device=q.device)
    mask = (pos[None, :] >= starts[:, None]) & (pos[None, :] < ends[:, None])  # keys
    mask = mask[:, None, None, None, :]
    if causal:
        q_off, k_off = offsets or (0, 0)
        mask = mask & (pos[None, :] + k_off <= pos[:, None] + q_off)
    return s, mask


def flash_attention_lse_reference(q, k, v, starts, ends, causal=True, offsets=None):
    """Plain version of the forward with log-sum-exp: (out (B, T, Hq, Dh) in
    q's dtype, lse (B, Hq, T) float32). As the TPU kernel: masked scores are
    -1e30, p is rounded to v's dtype before the value product, the
    denominator and the log are floored at 1e-30. float64 inputs run in
    float64 throughout (the float32 kernel's yardstick)."""
    B, T, Hq, Dh = q.shape
    s, mask = _masked_scores(q, k, starts, ends, causal, offsets)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).to(s.dtype), v.to(s.dtype)) / (
        l.permute(0, 3, 1, 2, 4))
    lse = (m + torch.log(l))[..., 0].reshape(B, Hq, T)
    return out.reshape(B, T, Hq, Dh).to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, dout, lse, delta, starts, ends, causal=True,
                                  offsets=None):
    """Plain version of both backward kernels: the TPU ``_bwd_*`` formulas
    written densely. ``delta`` = rowsum(dO * O) as (B, Hq, T) float32.
    Returns (dq, dk, dv) in q's dtype, dk/dv summed over the GQA group. As
    the TPU kernels, p and ds are rounded to the operands' dtype before
    their products; float64 inputs run in float64 throughout (the float32
    kernels' yardstick)."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, mask = _masked_scores(q, k, starts, ends, causal, offsets)
    acc = s.dtype  # float32, or float64 for float64 q
    lse_g = lse.reshape(B, Hkv, G, T, 1)
    p = torch.exp(torch.where(mask, s - lse_g, NEG_INF))  # masked → exactly 0
    dog = dout.reshape(B, T, Hkv, G, Dh).to(acc)
    dv = torch.einsum("bhgts,bthgd->bshd", p.to(dout.dtype).to(acc), dog)
    dp = torch.einsum("bthgd,bshd->bhgts", dog, v.to(acc))
    ds = p * (dp - delta.reshape(B, Hkv, G, T, 1))
    scale = Dh ** -0.5
    dq = torch.einsum("bhgts,bshd->bthgd", ds.to(k.dtype).to(acc), k.to(acc)) * scale
    qg = q.reshape(B, T, Hkv, G, Dh).to(acc)
    dk = torch.einsum("bhgts,bthgd->bshd", ds.to(q.dtype).to(acc), qg) * scale
    return dq.reshape(B, T, Hq, Dh).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _devices(what, tensors):
    devices = {t.device.type for t in tensors}
    if devices in ({"cpu"}, {"cuda"}):
        return devices.pop()
    raise ValueError(f"{what}: tensors on {sorted(devices)}; need all cpu or all cuda")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Attention over per-sample key windows; (B, T, Hq, Dh) out in q's
    dtype. CUDA tensors go to the bf16 kernel or, in float32, to
    ``flash_attention_fwd_f32``."""
    if _devices("flash_attention_fwd", (q, k, v, starts, ends)) == "cpu":
        return flash_attention_reference(q, k, v, starts, ends, causal)
    return _launch_fwd(_pick(flash_attention_fwd, q, k, v), q, k, v, starts, ends, causal)[0]


def flash_attention_fwd_f32(q, k, v, starts, ends, causal=True):
    """B1's float32 instance: float32 q, k, v in, float32 out, every score,
    p and sum in float32 (the TPU kernel at float32 operands)."""
    if _devices("flash_attention_fwd_f32", (q, k, v, starts, ends)) == "cpu":
        return flash_attention_reference(q, k, v, starts, ends, causal)
    return _launch_fwd(flash_attention_fwd_f32, q, k, v, starts, ends, causal)[0]


def flash_attention_fwd_lse(q, k, v, starts, ends, causal=True):
    """The forward for training: (out, lse (B, Hq, T) float32) in one
    launch of the B1 kernel (``flash_attention_fwd_lse_f32`` in float32)."""
    return _fwd_lse(flash_attention_fwd_lse, q, k, v, starts, ends, causal, None)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, starts, ends, causal=True):
    """dq (B, T, Hq, Dh) from the saved lse and delta = rowsum(dO * O)
    (``flash_attention_bwd_dq_f32`` in float32)."""
    return _bwd(flash_attention_bwd_dq, (q, k, v, dout, lse, delta, starts, ends), causal, None)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, starts, ends, causal=True):
    """(dk, dv) (B, T, Hkv, Dh), summed over each KV head's q-head group
    (``flash_attention_bwd_dkv_f32`` in float32)."""
    return _bwd(flash_attention_bwd_dkv, (q, k, v, dout, lse, delta, starts, ends), causal, None)


# the float32 instances of the training kernels (B1 + LSE and B6), each with
# its own launch count; the bf16 entry points route float32 tensors here


def flash_attention_fwd_lse_f32(q, k, v, starts, ends, causal=True):
    """B1 + LSE's float32 instance: float32 out and lse, every score, p and
    sum in float32."""
    return _fwd_lse(flash_attention_fwd_lse_f32, q, k, v, starts, ends, causal, None)


def flash_attention_bwd_dq_f32(q, k, v, dout, lse, delta, starts, ends, causal=True):
    """B6 dq's float32 instance: p, dp, ds and dq in float32."""
    return _bwd(flash_attention_bwd_dq_f32, (q, k, v, dout, lse, delta, starts, ends), causal,
                None)


def flash_attention_bwd_dkv_f32(q, k, v, dout, lse, delta, starts, ends, causal=True):
    """B6 dk/dv's float32 instance: float32 throughout, the group summed in
    a fixed order."""
    return _bwd(flash_attention_bwd_dkv_f32, (q, k, v, dout, lse, delta, starts, ends), causal,
                None)


# B7: the three entry points in offset mode, each with its own launch count


def flash_attention_fwd_lse_offset(q, k, v, starts, ends, offsets, causal=True):
    """B7 forward: ``flash_attention_fwd_lse`` at ``offsets`` = (q_off, k_off)."""
    return _fwd_lse(flash_attention_fwd_lse_offset, q, k, v, starts, ends, causal,
                    tuple(offsets))


def flash_attention_bwd_dq_offset(q, k, v, dout, lse, delta, starts, ends, offsets, causal=True):
    """B7 dq: ``flash_attention_bwd_dq`` at ``offsets`` = (q_off, k_off)."""
    return _bwd(flash_attention_bwd_dq_offset, (q, k, v, dout, lse, delta, starts, ends), causal,
                tuple(offsets))


def flash_attention_bwd_dkv_offset(q, k, v, dout, lse, delta, starts, ends, offsets,
                                   causal=True):
    """B7 dk/dv: ``flash_attention_bwd_dkv`` at ``offsets`` = (q_off, k_off)."""
    return _bwd(flash_attention_bwd_dkv_offset, (q, k, v, dout, lse, delta, starts, ends), causal,
                tuple(offsets))


def flash_attention_fwd_lse_offset_f32(q, k, v, starts, ends, offsets, causal=True):
    """B7 forward's float32 instance."""
    return _fwd_lse(flash_attention_fwd_lse_offset_f32, q, k, v, starts, ends, causal,
                    tuple(offsets))


def flash_attention_bwd_dq_offset_f32(q, k, v, dout, lse, delta, starts, ends, offsets,
                                      causal=True):
    """B7 dq's float32 instance."""
    return _bwd(flash_attention_bwd_dq_offset_f32, (q, k, v, dout, lse, delta, starts, ends),
                causal, tuple(offsets))


def flash_attention_bwd_dkv_offset_f32(q, k, v, dout, lse, delta, starts, ends, offsets,
                                       causal=True):
    """B7 dk/dv's float32 instance."""
    return _bwd(flash_attention_bwd_dkv_offset_f32, (q, k, v, dout, lse, delta, starts, ends),
                causal, tuple(offsets))


def _fwd_lse(wrapper, q, k, v, starts, ends, causal, offsets):
    if _devices(wrapper.__name__, (q, k, v, starts, ends)) == "cpu":
        return flash_attention_lse_reference(q, k, v, starts, ends, causal, offsets)
    return _launch_fwd(_pick(wrapper, q, k, v), q, k, v, starts, ends, causal, with_lse=True,
                       offsets=offsets)


def _bwd(wrapper, tensors, causal, offsets):
    if _devices(wrapper.__name__, tensors) == "cpu":
        dq, dk, dv = flash_attention_bwd_reference(*tensors, causal, offsets)
        return (dk, dv) if wrapper in _DKV_WRAPPERS else dq
    return _launch_bwd(_pick(wrapper, *tensors[:3]), *tensors, causal, offsets)


# each bf16 entry point's float32 instance, which its float32 calls count under
_F32_INSTANCES = {
    flash_attention_fwd: flash_attention_fwd_f32,
    flash_attention_fwd_lse: flash_attention_fwd_lse_f32,
    flash_attention_bwd_dq: flash_attention_bwd_dq_f32,
    flash_attention_bwd_dkv: flash_attention_bwd_dkv_f32,
    flash_attention_fwd_lse_offset: flash_attention_fwd_lse_offset_f32,
    flash_attention_bwd_dq_offset: flash_attention_bwd_dq_offset_f32,
    flash_attention_bwd_dkv_offset: flash_attention_bwd_dkv_offset_f32,
}
for _wrapper in (*_F32_INSTANCES, *_F32_INSTANCES.values()):
    _wrapper.launches = 0
_DKV_WRAPPERS = (flash_attention_bwd_dkv, flash_attention_bwd_dkv_offset,
                 flash_attention_bwd_dkv_f32, flash_attention_bwd_dkv_offset_f32)
_F32_WRAPPERS = frozenset(_F32_INSTANCES.values())


class FlashAttention(torch.autograd.Function):
    """B1 with LSE forward, B6 backward. The forward saves q, k, v, out and
    lse; the backward computes delta = rowsum(dO * O) in PyTorch (the TPU
    code computes it in XLA) and launches the dq and dk/dv kernels, or on
    CPU tensors runs their plain versions. It runs on autograd's thread,
    on the current stream of the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, starts, ends, causal):
        out, lse = flash_attention_fwd_lse(q, k, v, starts, ends, causal)
        ctx.save_for_backward(q, k, v, out, lse, starts, ends)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, starts, ends = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # (B, Hq, T)
        args = (q, k, v, dout, lse, delta, starts, ends, ctx.causal)
        dq = flash_attention_bwd_dq(*args)
        dk, dv = flash_attention_bwd_dkv(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, starts, ends, causal: bool = True) -> torch.Tensor:
    """Differentiable attention over per-sample key windows. Where no
    gradient is wanted (grad mode off, or no input requires one) it is the
    plain forward kernel ``flash_attention_fwd`` (bf16 or float32);
    otherwise the forward also writes the log-sum-exp and the backward runs
    kernel B6; CUDA tensors take the bf16 kernels or, in float32, their
    float32 instances."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, starts, ends, causal)
    return flash_attention_fwd(q, k, v, starts, ends, causal)


# ---- the CUDA launches


def _lib():
    lib = load_library("flash_attention", SOURCES)
    fn = lib.lss_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _f32_lib():
    """B1's float32 library: ``lss_flash_attention_f32_fwd``, for B1, B1 +
    LSE and B7's forward (the bf16 forward's arguments)."""
    fn = load_library("flash_attention_f32", F32_SOURCES).lss_flash_attention_f32_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_f32_lib(dkv):
    """The float32 backward library: ``lss_flash_attention_bwd_dq_f32`` or,
    with ``dkv``, ``lss_flash_attention_bwd_dkv_f32``."""
    lib = load_library("flash_attention_bwd_f32", BWD_F32_SOURCES)
    if dkv:
        return _bwd_entry(lib.lss_flash_attention_bwd_dkv_f32, 2)
    return _bwd_entry(lib.lss_flash_attention_bwd_dq_f32, 1)


def _bwd_lib():
    """The dq library: ``lss_flash_attention_bwd_dq``."""
    return _bwd_entry(load_library("flash_attention_bwd", BWD_SOURCES).lss_flash_attention_bwd_dq,
                      1)


def _dkv_lib():
    """The dk/dv library: ``lss_flash_attention_bwd_dkv``."""
    return _bwd_entry(
        load_library("flash_attention_dkv", DKV_SOURCES).lss_flash_attention_bwd_dkv, 2)


def _bwd_entry(fn, outs):
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (6 + outs) + [p, p, i, i, i, i, i, p, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _route(what, q, k, v):
    """The dtype a CUDA call runs in: bfloat16 or float32 (every entry point
    has an instance of each). Anything else raises, naming what is ported."""
    dtypes = {q.dtype, k.dtype, v.dtype}
    if len(dtypes) > 1:
        raise ValueError(f"{what}: mixed dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} are not "
                         f"ported; q, k and v must share bfloat16 or float32")
    dtype = dtypes.pop()
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: {dtype} is not ported; the kernels take bfloat16 or float32")
    return dtype


def _pick(wrapper, q, k, v):
    """The wrapper whose kernel a CUDA call launches and counts: a bf16
    entry point's float32 instance for float32 tensors, else itself (whose
    launch then checks the operands' dtype)."""
    if _route(wrapper.__name__, q, k, v) == torch.float32:
        return _F32_INSTANCES.get(wrapper, wrapper)
    return wrapper


def _check_operand(what: str, name: str, t: torch.Tensor, dtype=torch.bfloat16) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {str(dtype)[6:]}, got {t.dtype}")
    # 16-byte aligned base and byte strides that are positive multiples of
    # 16 (a dimension of size 1 never uses its stride): TMA's rules for the
    # bf16 kernels, the float4 row loads of the float32 one
    step = 16 // t.element_size()
    bad = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1 and (s <= 0 or s % step)]
    if t.stride(-1) != 1 or bad or t.data_ptr() % 16:
        raise ValueError(
            f"{what}: {name} needs a unit last stride, (b, t, h) strides that are positive "
            f"multiples of {step} and a 16-byte aligned base; got strides {t.stride()}"
        )


def _check_shapes(what, q, k, v, starts, ends, others=(), dtype=torch.bfloat16):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be (B, T, H, Dh)")
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, T, Hkv, Dh) or v.shape != k.shape:
        raise ValueError(f"{what}: k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"{what}: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if Dh not in (64, 128):
        raise ValueError(f"{what}: the kernel takes Dh in (64, 128), got {Dh}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(others):
        _check_operand(what, name, t, dtype)
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous ({B},) int32 tensor")
    if len({t.device for t in (q, k, v, starts, ends)}) != 1:
        raise ValueError(f"{what}: all tensors must be on one device")
    return B, T, Hq, Hkv, Dh


def _launch_fwd(wrapper, q, k, v, starts, ends, causal, with_lse=False, offsets=None):
    """One forward launch: the bf16 kernel, or ``wrapper``'s float32
    instance."""
    what = wrapper.__name__
    dtype = torch.float32 if wrapper in _F32_WRAPPERS else torch.bfloat16
    B, T, Hq, Hkv, Dh = _check_shapes(what, q, k, v, starts, ends, dtype=dtype)
    out = torch.empty((B, T, Hq, Dh), dtype=dtype, device=q.device)
    lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(*(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                                         + out.stride()[:3]))
    q_off, k_off = _offsets(what, offsets)
    fn = _f32_lib() if dtype == torch.float32 else _lib()
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                    B, T, Hq, Hkv, Dh, strides, int(causal), q_off, k_off, Dh ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    count_launch(wrapper)
    check_status(status, what)
    return out, lse


def _offsets(what, offsets):
    """(q_off, k_off) as host ints; (0, 0) without offset mode."""
    if offsets is None:
        return 0, 0
    if len(offsets) != 2 or not all(isinstance(o, int) for o in offsets):
        raise ValueError(f"{what}: offsets must be two host ints (q_off, k_off), got {offsets!r}")
    return offsets


def _launch_bwd(wrapper, q, k, v, dout, lse, delta, starts, ends, causal, offsets=None):
    what = wrapper.__name__
    dtype = torch.float32 if wrapper in _F32_WRAPPERS else torch.bfloat16
    B, T, Hq, Hkv, Dh = _check_shapes(what, q, k, v, starts, ends, (("dout", dout),),
                                      dtype=dtype)
    if dout.shape != q.shape:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} does not match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, Hq, T) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous ({B}, {Hq}, {T}) float32 "
                             f"tensor")
    if len({t.device for t in (q, dout, lse, delta)}) != 1:
        raise ValueError(f"{what}: all tensors must be on one device")
    dkv = wrapper in _DKV_WRAPPERS
    if dkv:
        outs = tuple(torch.empty((B, T, Hkv, Dh), dtype=dtype, device=q.device)
                     for _ in range(2))
        dq_s, dk_s, dv_s = (0, 0, 0), outs[0].stride()[:3], outs[1].stride()[:3]
    else:
        outs = (torch.empty((B, T, Hq, Dh), dtype=dtype, device=q.device),)
        dq_s, dk_s, dv_s = outs[0].stride()[:3], (0, 0, 0), (0, 0, 0)
    strides = (ctypes.c_longlong * 21)(*(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                                         + dout.stride()[:3] + dq_s + dk_s + dv_s))
    q_off, k_off = _offsets(what, offsets)
    if dtype == torch.float32:
        fn = _bwd_f32_lib(dkv)
    else:
        fn = _dkv_lib() if dkv else _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), *(o.data_ptr() for o in outs), starts.data_ptr(),
                    ends.data_ptr(), B, T, Hq, Hkv, Dh, strides, int(causal), q_off, k_off,
                    Dh ** -0.5, stream)
    count_launch(wrapper)
    check_status(status, what)
    return outs if dkv else outs[0]
