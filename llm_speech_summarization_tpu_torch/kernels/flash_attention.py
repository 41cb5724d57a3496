"""Flash-attention forward (kernel B1): wrapper, plain version, launch count.

Port of ``llm_speech_summarization_tpu/kernels/flash_attention.py``
(forward only). The CUDA kernel is ``csrc/flash_attention.cu``; its header
note says what bounds it on the H100 and how this first design meets that.

q (B, T, Hq, Dh); k, v (B, T, Hkv, Dh); starts/ends (B,) int32: sample b's
valid keys are [start_b, end_b), causal means query i sees keys j <= i.
Queries outside the window produce finite garbage rows that callers mask
downstream (the JAX contract). CPU tensors take the plain version; CUDA
tensors launch the kernel, and any shape, dtype or layout the kernel does
not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.attention import dot_product_attention, make_attention_bias
from .build import check_status, count_launch, load_library

SOURCES = ("flash_attention.cu",)


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


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Attention over per-sample key windows; (B, T, Hq, Dh) out."""
    devices = {t.device.type for t in (q, k, v, starts, ends)}
    if devices == {"cpu"}:
        return flash_attention_reference(q, k, v, starts, ends, causal)
    if devices == {"cuda"}:
        return _launch(q, k, v, starts, ends, causal)
    raise ValueError(f"flash_attention_fwd: tensors on {sorted(devices)}; need all cpu or all cuda")


flash_attention_fwd.launches = 0


def _lib():
    lib = load_library("flash_attention", SOURCES)
    fn = lib.lss_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_operand(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_fwd: {name} must be bfloat16, got {t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention_fwd: {name} needs a unit last stride, (b, t, h) strides "
            f"that are multiples of 8 and a 16-byte aligned base; got strides {t.stride()}"
        )


def _launch(q, k, v, starts, ends, causal):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention_fwd: q, k, v must be (B, T, H, Dh)")
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, T, Hkv, Dh) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"flash_attention_fwd: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if Dh not in (64, 128):
        raise ValueError(f"flash_attention_fwd: the kernel takes Dh in (64, 128), got {Dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t)
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be a contiguous ({B},) int32 tensor")
    if len({t.device for t in (q, k, v, starts, ends)}) != 1:
        raise ValueError("flash_attention_fwd: all tensors must be on one device")
    out = torch.empty((B, T, Hq, Dh), dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                                         + out.stride()[:3]))
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    starts.data_ptr(), ends.data_ptr(), B, T, Hq, Hkv, Dh, strides,
                    int(causal), Dh ** -0.5, stream)
    count_launch(flash_attention_fwd)
    check_status(status, "flash_attention_fwd")
    return out
