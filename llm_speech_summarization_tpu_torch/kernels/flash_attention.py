"""Flash attention: the forward (kernel B1), its log-sum-exp variant and the
FlashAttention-2 backward (kernel B6: dq and dk/dv), with their plain
versions, launch counts and the differentiable ``flash_attention``.

Port of ``llm_speech_summarization_tpu/kernels/flash_attention.py``. The
CUDA kernels are ``csrc/flash_attention.cu`` (forward, optionally writing
the log-sum-exp) and ``csrc/flash_attention_bwd.cu`` (dq; dk/dv summed over
the GQA group); their header notes say what bounds them on the H100 and how
these first designs meet that.

q (B, T, Hq, Dh); k, v (B, T, Hkv, Dh); starts/ends (B,) int32: sample b's
valid keys are [start_b, end_b), causal means query i sees keys j <= i.
Queries outside the window produce finite garbage rows that callers mask
downstream (the JAX contract). The log-sum-exp is float32 (B, Hq, T); a
row with no valid key gets -1e30, as the TPU kernel writes. CPU tensors
take the plain versions; CUDA tensors launch the kernels, and any shape,
dtype or layout the kernels do not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.attention import NEG_INF, dot_product_attention, make_attention_bias
from .build import check_status, count_launch, load_library

SOURCES = ("flash_attention.cu", "flash_common.cuh")
BWD_SOURCES = ("flash_attention_bwd.cu", "flash_common.cuh")


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


def _masked_scores(q, k, starts, ends, causal):
    """float32 scores (B, Hkv, G, T, S) = scale * q.k^T and the key mask
    (B, 1, 1, T, S) of the window and the causal rule."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, Dh).float()
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * Dh ** -0.5
    pos = torch.arange(T, dtype=torch.int32, device=q.device)
    mask = (pos[None, :] >= starts[:, None]) & (pos[None, :] < ends[:, None])  # keys
    mask = mask[:, None, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    return s, mask


def flash_attention_lse_reference(q, k, v, starts, ends, causal=True):
    """Plain version of the forward with log-sum-exp: (out (B, T, Hq, Dh) in
    q's dtype, lse (B, Hq, T) float32). As the TPU kernel: masked scores are
    -1e30, p is rounded to v's dtype before the value product, the
    denominator and the log are floored at 1e-30."""
    B, T, Hq, Dh = q.shape
    s, mask = _masked_scores(q, k, starts, ends, causal)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float()) / (
        l.permute(0, 3, 1, 2, 4))
    lse = (m + torch.log(l))[..., 0].reshape(B, Hq, T)
    return out.reshape(B, T, Hq, Dh).to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, dout, lse, delta, starts, ends, causal=True):
    """Plain version of both backward kernels: the TPU ``_bwd_*`` formulas
    written densely. ``delta`` = rowsum(dO * O) as (B, Hq, T) float32.
    Returns (dq, dk, dv) in q's dtype, dk/dv summed over the GQA group."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, mask = _masked_scores(q, k, starts, ends, causal)
    lse_g = lse.reshape(B, Hkv, G, T, 1)
    p = torch.exp(torch.where(mask, s - lse_g, NEG_INF))  # masked → exactly 0
    dog = dout.reshape(B, T, Hkv, G, Dh).float()
    dv = torch.einsum("bhgts,bthgd->bshd", p.to(dout.dtype).float(), dog)
    dp = torch.einsum("bthgd,bshd->bhgts", dog, v.float())
    ds = p * (dp - delta.reshape(B, Hkv, G, T, 1))
    scale = Dh ** -0.5
    dq = torch.einsum("bhgts,bshd->bthgd", ds.to(k.dtype).float(), k.float()) * scale
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    dk = torch.einsum("bhgts,bthgd->bshd", ds.to(q.dtype).float(), qg) * scale
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
    """Attention over per-sample key windows; (B, T, Hq, Dh) out."""
    if _devices("flash_attention_fwd", (q, k, v, starts, ends)) == "cpu":
        return flash_attention_reference(q, k, v, starts, ends, causal)
    out, _ = _launch_fwd(flash_attention_fwd, q, k, v, starts, ends, causal, with_lse=False)
    return out


def flash_attention_fwd_lse(q, k, v, starts, ends, causal=True):
    """The forward for training: (out, lse (B, Hq, T) float32) in one
    launch of the B1 kernel."""
    if _devices("flash_attention_fwd_lse", (q, k, v, starts, ends)) == "cpu":
        return flash_attention_lse_reference(q, k, v, starts, ends, causal)
    return _launch_fwd(flash_attention_fwd_lse, q, k, v, starts, ends, causal, with_lse=True)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, starts, ends, causal=True):
    """dq (B, T, Hq, Dh) from the saved lse and delta = rowsum(dO * O)."""
    tensors = (q, k, v, dout, lse, delta, starts, ends)
    if _devices("flash_attention_bwd_dq", tensors) == "cpu":
        return flash_attention_bwd_reference(*tensors, causal)[0]
    return _launch_bwd(flash_attention_bwd_dq, *tensors, causal)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, starts, ends, causal=True):
    """(dk, dv) (B, T, Hkv, Dh), summed over each KV head's q-head group."""
    tensors = (q, k, v, dout, lse, delta, starts, ends)
    if _devices("flash_attention_bwd_dkv", tensors) == "cpu":
        return flash_attention_bwd_reference(*tensors, causal)[1:]
    return _launch_bwd(flash_attention_bwd_dkv, *tensors, causal)


for _wrapper in (flash_attention_fwd, flash_attention_fwd_lse, flash_attention_bwd_dq,
                 flash_attention_bwd_dkv):
    _wrapper.launches = 0


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
    plain forward kernel ``flash_attention_fwd``; otherwise the forward also
    writes the log-sum-exp and the backward runs kernel B6."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, starts, ends, causal)
    return flash_attention_fwd(q, k, v, starts, ends, causal)


# ---- the CUDA launches


def _lib():
    lib = load_library("flash_attention", SOURCES)
    fn = lib.lss_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = load_library("flash_attention_bwd", BWD_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [p, p, i, i, i, i, i, p, i, ctypes.c_float, p]
    for fn, outs in ((lib.lss_flash_attention_bwd_dq, 1), (lib.lss_flash_attention_bwd_dkv, 2)):
        if fn.argtypes is None:
            fn.argtypes = [p] * (6 + outs) + tail
            fn.restype = ctypes.c_int
    return lib


def _check_operand(what: str, name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{what}: {name} must be bfloat16, got {t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"{what}: {name} needs a unit last stride, (b, t, h) strides "
            f"that are multiples of 8 and a 16-byte aligned base; got strides {t.stride()}"
        )


def _check_shapes(what, q, k, v, starts, ends, others=()):
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
        _check_operand(what, name, t)
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous ({B},) int32 tensor")
    if len({t.device for t in (q, k, v, starts, ends)}) != 1:
        raise ValueError(f"{what}: all tensors must be on one device")
    return B, T, Hq, Hkv, Dh


def _launch_fwd(wrapper, q, k, v, starts, ends, causal, with_lse):
    B, T, Hq, Hkv, Dh = _check_shapes(wrapper.__name__, q, k, v, starts, ends)
    out = torch.empty((B, T, Hq, Dh), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(*(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                                         + out.stride()[:3]))
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), starts.data_ptr(),
                    ends.data_ptr(), B, T, Hq, Hkv, Dh, strides, int(causal), Dh ** -0.5,
                    stream)
    count_launch(wrapper)
    check_status(status, wrapper.__name__)
    return out, lse


def _launch_bwd(wrapper, q, k, v, dout, lse, delta, starts, ends, causal):
    what = wrapper.__name__
    B, T, Hq, Hkv, Dh = _check_shapes(what, q, k, v, starts, ends, (("dout", dout),))
    if dout.shape != q.shape:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} does not match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, Hq, T) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous ({B}, {Hq}, {T}) float32 "
                             f"tensor")
    if len({t.device for t in (q, dout, lse, delta)}) != 1:
        raise ValueError(f"{what}: all tensors must be on one device")
    dkv = wrapper is flash_attention_bwd_dkv
    if dkv:
        outs = tuple(torch.empty((B, T, Hkv, Dh), dtype=torch.bfloat16, device=q.device)
                     for _ in range(2))
        dq_s, dk_s, dv_s = (0, 0, 0), outs[0].stride()[:3], outs[1].stride()[:3]
    else:
        outs = (torch.empty((B, T, Hq, Dh), dtype=torch.bfloat16, device=q.device),)
        dq_s, dk_s, dv_s = outs[0].stride()[:3], (0, 0, 0), (0, 0, 0)
    strides = (ctypes.c_longlong * 21)(*(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                                         + dout.stride()[:3] + dq_s + dk_s + dv_s))
    lib = _bwd_lib()
    fn = lib.lss_flash_attention_bwd_dkv if dkv else lib.lss_flash_attention_bwd_dq
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), *(o.data_ptr() for o in outs), starts.data_ptr(),
                    ends.data_ptr(), B, T, Hq, Hkv, Dh, strides, int(causal), Dh ** -0.5,
                    stream)
    count_launch(wrapper)
    check_status(status, what)
    return outs if dkv else outs[0]
