"""The routed experts of a DeepSeek-V3 MoE layer (kernel K1): the sort of
the token-expert pairs by expert, the two grouped GEMM launches, the
combine; wrappers, plain versions, launch counts.

K1 replaces no TPU kernel (the JAX package has no sparse experts); its
CUDA source, ``csrc/moe_experts.cu``, says what bounds it on the H100 and
how its design meets that. The pairs a layer computes are sorted on the
device with no value read on the host (``sort_by_expert``: a count and a
scatter, one launch for a decode step's pairs), so a CUDA graph can
capture the whole layer; the grid of
each launch is sized for the worst case from the host-known number of
pairs.

* ``moe_gateup`` (the first launch): the sorted rows' tokens of ``x``
  against their expert's gate and up rows, ``silu(g) * u`` rounded as the
  plain version rounds it (each of g, u, silu(g) and the product to the
  activation dtype);
* ``moe_down`` (the second): those rows against their expert's down rows,
  float32, into a buffer whose last row stays zero;
* ``combine`` (a third launch): each token's k rows weighted and summed
  in the order of its choices (float32, rounded once to the activation
  dtype; no atomics, so repeats are bit-identical). Tokens left out
  (``valid`` false) take the zero row;
* ``moe_experts``: the three.

Layouts: expert weights are (E, out, in), the HF ``Linear`` orientation, so
that both operands of each product run along the reduced width: the gate
and up rows stacked (E, 2I, D), the down rows (E, D, I).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .build import check_status, count_launch, load_library
from .fused_decode import _devices

SOURCES = ("moe_experts.cu",)
# at most this many rows an expert on average (a decode step's ~12 at
# B = 128) take the 32-row tile, whose one tile an expert reads its weights
# once a call; more (a prefill's ~1,800) take the 128-row tile
DECODE_ROWS_PER_EXPERT = 24
MAX_EXPERTS = 256


class Routing(NamedTuple):
    """The token-expert pairs sorted by expert."""

    tok: torch.Tensor  # (N * k,) int32: the token of each sorted row
    offsets: torch.Tensor  # (E + 1,) int32: expert e's rows [offsets[e], offsets[e + 1])
    dest: torch.Tensor  # (N, k) int64: each choice's sorted row; N * k (the zero row) if left out
    counts: torch.Tensor  # (E,) int32: rows an expert


def sort_by_expert(sel: torch.Tensor, n_experts: int,
                   valid: Optional[torch.Tensor] = None) -> Routing:
    """``sel`` (N, k) expert ids → the pairs sorted by expert, with no host
    read. The pairs of tokens where ``valid`` (N,) is false go to a last
    group that no launch computes. On the card the kernel counts the pairs
    in blocks of 4,096 and scatters them (one launch where one block holds
    them all, as a decode step's do), the order inside an expert's segment
    left to its atomics (no result depends on it); on the CPU,
    ``sort_by_expert_reference``."""
    N, k = sel.shape
    if sel.device.type != "cuda":
        return sort_by_expert_reference(sel, n_experts, valid)
    if sel.dtype != torch.int64 or not sel.is_contiguous() or n_experts > MAX_EXPERTS:
        raise ValueError(f"sort_by_expert: the kernel takes contiguous int64 choices of at most "
                         f"{MAX_EXPERTS} experts, got {sel.dtype} and {n_experts}")
    dev = sel.device
    lib = _lib()
    tok = torch.empty(N * k, dtype=torch.int32, device=dev)
    rank = torch.empty(N * k, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_experts + 1, dtype=torch.int32, device=dev)
    counts = torch.empty(n_experts, dtype=torch.int32, device=dev)
    dest = torch.empty((N, k), dtype=torch.int64, device=dev)
    blocks = lib.lss_moe_align_blocks(N * k)
    base = torch.empty((blocks, n_experts + 1), dtype=torch.int32, device=dev)
    done = torch.zeros(1, dtype=torch.int32, device=dev) if blocks > 1 else None
    flags = None if valid is None else valid.to(torch.uint8).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.lss_moe_align(sel.data_ptr(), None if flags is None else flags.data_ptr(),
                                   N, k, n_experts, tok.data_ptr(), offsets.data_ptr(),
                                   dest.data_ptr(), counts.data_ptr(), rank.data_ptr(),
                                   base.data_ptr(), None if done is None else done.data_ptr(),
                                   stream)
    count_launch(sort_by_expert)
    check_status(status, "sort_by_expert")
    return Routing(tok, offsets, dest, counts)


def sort_by_expert_reference(sel: torch.Tensor, n_experts: int,
                             valid: Optional[torch.Tensor] = None) -> Routing:
    """The pairs sorted by expert stably (a token's rows in token order
    within its expert) by a comparison against the expert ids, a scan and a
    scatter, with no host read."""
    N, k = sel.shape
    dev = sel.device
    e = sel.reshape(-1).long()
    if valid is not None:
        e = torch.where(valid.reshape(N, 1).expand(N, k).reshape(-1), e,
                        torch.full_like(e, n_experts))
    groups = torch.arange(n_experts + 1, device=dev)
    # (E + 1, N * k), each group's row scanned along its contiguous last axis
    onehot = (groups[:, None] == e[None, :]).to(torch.int32)
    counts = onehot.sum(1, dtype=torch.int32)
    rank = torch.cumsum(onehot, 1, dtype=torch.int32).gather(0, e[None, :])[0] - 1
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    dest = starts.long()[e] + rank.long()
    tok = torch.zeros(N * k, dtype=torch.int32, device=dev)
    tok.scatter_(0, dest, torch.arange(N * k, dtype=torch.int32, device=dev) // k)
    dest = torch.where(e == n_experts, torch.full_like(dest, N * k), dest)
    return Routing(tok, starts[: n_experts + 1].contiguous(), dest.reshape(N, k),
                   counts[:n_experts])


def _expert_of_rows(offsets: torch.Tensor, rows: int) -> torch.Tensor:
    """The expert of each sorted row ((rows,), E past the last segment)."""
    r = torch.arange(rows, dtype=torch.int32, device=offsets.device)
    return torch.searchsorted(offsets[1:].contiguous(), r, right=True)


def moe_gateup_reference(x, tok, offsets, w_gateup):
    """Plain version of the first launch: (rows, I) in x's dtype, each
    expert's rows through its gate and up rows (products in float32);
    rows past the last segment are zero."""
    E, I2, _ = w_gateup.shape
    I = I2 // 2
    rows = tok.shape[0]
    xr = x[tok.long()].float()
    expert = _expert_of_rows(offsets, rows)[:, None]
    h = torch.zeros((rows, I), dtype=x.dtype, device=x.device)
    for j in range(E):
        w = w_gateup[j].float()
        g = (xr @ w[:I].t()).to(x.dtype)
        u = (xr @ w[I:].t()).to(x.dtype)
        h = torch.where(expert == j, F.silu(g) * u, h)
    return h


def moe_down_reference(h, offsets, w_down):
    """Plain version of the second launch: (rows + 1, D) float32, the last
    row and rows past the last segment zero."""
    E, D, _ = w_down.shape
    rows = h.shape[0]
    expert = _expert_of_rows(offsets, rows)[:, None]
    y = torch.zeros((rows + 1, D), dtype=torch.float32, device=h.device)
    hf = h.float()
    for j in range(E):
        y[:rows] = torch.where(expert == j, hf @ w_down[j].float().t(), y[:rows])
    return y


def _check(what, x, w):
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bfloat16 activations and weights, got "
                         f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{what}: operands must be contiguous with a 16-byte aligned base")
    if w.shape[0] > MAX_EXPERTS:
        raise ValueError(f"{what}: at most {MAX_EXPERTS} experts, got {w.shape[0]}")


def _tile_rows(rows: int, E: int) -> int:
    return 32 if rows <= DECODE_ROWS_PER_EXPERT * E else 128


def _lib():
    lib = load_library("moe_experts", SOURCES)
    if lib.lss_moe_gateup.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lss_moe_gateup.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.lss_moe_gateup.restype = ctypes.c_int
        lib.lss_moe_down.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.lss_moe_down.restype = ctypes.c_int
        lib.lss_moe_combine.argtypes = [p] * 4 + [i] * 3 + [p]
        lib.lss_moe_combine.restype = ctypes.c_int
        lib.lss_moe_align.argtypes = [p, p, i, i, i] + [p] * 7 + [p]
        lib.lss_moe_align.restype = ctypes.c_int
        lib.lss_moe_align_blocks.argtypes = [i]
        lib.lss_moe_align_blocks.restype = ctypes.c_int
    return lib


def moe_gateup(x: torch.Tensor, tok: torch.Tensor, offsets: torch.Tensor,
               w_gateup: torch.Tensor) -> torch.Tensor:
    """K1's first launch: x (N, D), the sorted rows' tokens ``tok`` (rows,)
    int32, ``offsets`` (E + 1,) int32 and w_gateup (E, 2I, D) → (rows, I);
    rows past ``offsets[E]`` are not written on the card."""
    what = "moe_gateup"
    if _devices(what, (x, tok, offsets, w_gateup)) == "cpu":
        return moe_gateup_reference(x, tok, offsets, w_gateup)
    _check(what, x, w_gateup)
    E, I2, D = w_gateup.shape
    I = I2 // 2
    if x.shape[1] != D or D % 32 or I % 64:
        raise ValueError(f"{what}: x {tuple(x.shape)} against w_gateup {tuple(w_gateup.shape)}; "
                         "the kernel takes D % 32 == 0 and I % 64 == 0")
    rows = tok.shape[0]
    h = torch.empty((rows, I), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib().lss_moe_gateup(x.data_ptr(), tok.data_ptr(), offsets.data_ptr(),
                                       w_gateup.data_ptr(), h.data_ptr(), rows, E, D, I,
                                       _tile_rows(rows, E), stream)
    count_launch(moe_gateup)
    check_status(status, what)
    return h


def moe_down(h: torch.Tensor, offsets: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """K1's second launch: h (rows, I), ``offsets`` (E + 1,) and w_down (E,
    D, I) → (rows + 1, D) float32, its last row zero; rows past
    ``offsets[E]`` are not written on the card."""
    what = "moe_down"
    if _devices(what, (h, offsets, w_down)) == "cpu":
        return moe_down_reference(h, offsets, w_down)
    _check(what, h, w_down)
    E, D, I = w_down.shape
    if h.shape[1] != I or I % 32 or D % 128:
        raise ValueError(f"{what}: h {tuple(h.shape)} against w_down {tuple(w_down.shape)}; the "
                         "kernel takes I % 32 == 0 and D % 128 == 0")
    rows = h.shape[0]
    y = torch.empty((rows + 1, D), dtype=torch.float32, device=h.device)
    y[rows].zero_()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        status = _lib().lss_moe_down(h.data_ptr(), offsets.data_ptr(), w_down.data_ptr(),
                                     y.data_ptr(), rows, E, D, I, _tile_rows(rows, E), stream)
    count_launch(moe_down)
    check_status(status, what)
    return y


moe_gateup.launches = 0
moe_down.launches = 0


def combine_reference(y, dest, weights, dtype):
    """Plain version of the combine: (N, D) in ``dtype``, each token's k
    rows of ``y`` at ``dest`` (N, k) times its ``weights`` (N, k), summed in
    float32 in the order of the choices."""
    out = weights[:, :1].float() * torch.index_select(y, 0, dest[:, 0])
    for j in range(1, dest.shape[1]):
        out = out + weights[:, j:j + 1].float() * torch.index_select(y, 0, dest[:, j])
    return out.to(dtype)


def combine(y: torch.Tensor, dest: torch.Tensor, weights: torch.Tensor,
            dtype=torch.bfloat16) -> torch.Tensor:
    """K1's combine (see ``combine_reference``); on the card one launch,
    bf16 out."""
    what = "moe_combine"
    if _devices(what, (y, dest, weights)) == "cpu":
        return combine_reference(y, dest, weights, dtype)
    N, k = dest.shape
    D = y.shape[1]
    if (dtype != torch.bfloat16 or y.dtype != torch.float32 or dest.dtype != torch.int64
            or not (y.is_contiguous() and dest.is_contiguous()) or D % 4 or y.data_ptr() % 16):
        raise ValueError(f"{what}: the kernel takes a contiguous float32 y with 4 | D, int64 "
                         f"dest and a bfloat16 out, got {y.dtype} {dest.dtype} {dtype}")
    w = weights.float().contiguous()
    out = torch.empty((N, D), dtype=dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        status = _lib().lss_moe_combine(y.data_ptr(), dest.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), N, k, D, stream)
    count_launch(combine)
    check_status(status, what)
    return out


combine.launches = 0
sort_by_expert.launches = 0


def moe_experts(x: torch.Tensor, routing: Routing, weights: torch.Tensor,
                w_gateup: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The routed experts' weighted sum (N, D) in x's dtype for x (N, D)
    under ``routing`` (``sort_by_expert``) and the choices' ``weights`` (N,
    k): the sum in float32, rounded once."""
    h = moe_gateup(x, routing.tok, routing.offsets, w_gateup)
    y = moe_down(h, routing.offsets, w_down)
    return combine(y, routing.dest, weights, x.dtype)
