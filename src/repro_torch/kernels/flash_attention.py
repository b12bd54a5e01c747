"""Causal flash attention (online softmax over kv tiles).

Wrapper over ``csrc/flash_attention.cu`` (replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``), with the JAX
signature and layout: q (B, H, S, dh), k/v (B, H_kv, S, dh). ``H_kv < H``
is grouped-query attention: query head h reads kv head h // (H / H_kv),
which is the Pallas kernel applied to ``jnp.repeat(k, H // H_kv, axis=1)``,
without the copy. Any element strides are taken as long as the dh axis is
contiguous, so a (B, S, H, dh) tensor passes as its ``transpose(1, 2)``
view; the output is dense with q's axis order, so a (B, S, H, dh) tensor
gets its output back in that layout. For CPU tensors it
runs the plain version, ``ref.flash_attention_ref``.

On CUDA tensors one of the kernel's two bodies runs, by the rule in
:func:`select_body`: the tensor-core body (``wgmma`` on TMA-staged Q/K/V,
a persistent grid over :func:`wgmma_schedule`, shared memory
:func:`wgmma_smem_bytes`) for bf16 that TMA can address, the CUDA-core
body for the rest. Each body counts its own launches (``launches_wgmma``,
``launches``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import check_forward_only, check_on, resolve_device
from repro_torch.kernels import _build, ref

MAX_DH = 256
WGMMA_MAX_DH = 128
WGMMA, SIMT = "flash_attention_wgmma", "flash_attention"
# query rows per block and kv rows per tile of the CUDA-core body (simt::kB)
SIMT_ROWS = 64
# The tensor-core body's constants (csrc/flash_attention.cu, namespace tc)
WGMMA_ROWS = 128          # query rows per work item and kv rows per tile (kBQ, kBK)
WGMMA_REGION = 128 * 128  # bytes of one 64-column region of a 128-row bf16 tile (kRegion)


def wgmma_stages(dh: int) -> int:
    """The tensor-core body's K and V ring depth for head dim ``dh``
    (``tc::stages<NC>``): 4 at dh up to 64, 2 above."""
    return 4 if dh <= 64 else 2


def wgmma_smem_bytes(dh: int) -> int:
    """Shared memory of one tensor-core block (``tc::smem_bytes<NC>``): Q,
    the K ring, the V ring and the O staging tile, each slot a 128-row tile
    of NC 64-column regions (NC = dh / 64 rounded up); 4 mbarriers per ring
    stage and 2 for Q; 1 KB to align the base for the 128-byte swizzle."""
    nc, st = -(-dh // 64), wgmma_stages(dh)
    return (2 + 2 * st) * nc * WGMMA_REGION + 8 * (4 * st + 2) + 1024


def wgmma_schedule(B: int, H: int, S: int, sms: int = _build.SMS):
    """The tensor-core body's persistent schedule (``tc::item_at``): a
    list per block of the grid (``min(sms, items)`` blocks) of the work
    items it walks, in order, each as (query tile, head, batch row). Items
    are numbered heaviest first (item L: query tile n_q - 1 - L // (H B),
    head L % H, batch row (L // H) % B; a query tile qt walks qt + 1 kv
    tiles) and dealt in rows of the grid size, every other row backwards."""
    n_q = -(-S // WGMMA_ROWS)
    n = n_q * H * B
    G = min(sms, n)
    blocks = []
    for blk in range(G):
        items = []
        for r in range(-(-n // G)):
            L = r * G + (G - 1 - blk if r % 2 else blk)
            if L >= n:
                break
            hb = L % (H * B)
            items.append((n_q - 1 - L // (H * B), hb % H, hb // H))
        blocks.append(items)
    return blocks


class SimtTile(NamedTuple):
    """The CUDA-core body's build for a head dim (``simt::Cfg<DH>`` in the
    .cu): ``dh_class`` the head dim it is compiled for (dh rounded up to
    64, 128 or 256), ``threads`` per block, ``blocks_per_sm`` its launch
    bound, ``smem_bytes`` of dynamic shared memory per block (Q and two
    K/V tile slots in the input type, P in fp32)."""

    dh_class: int
    threads: int
    blocks_per_sm: int
    smem_bytes: int


def simt_tile(dh: int, dtype: torch.dtype) -> SimtTile:
    """The CUDA-core body's tiles for head dim ``dh`` (1 to 256)."""
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head dim {dh} outside [1, {MAX_DH}]")
    dhc = 64 if dh <= 64 else 128 if dh <= 128 else 256
    elem = torch.empty((), dtype=dtype).element_size()
    return SimtTile(dhc, 128 if dhc <= 128 else 256, 2 if dhc <= 128 else 1,
                    3 * SIMT_ROWS * dhc * elem + SIMT_ROWS * SIMT_ROWS * 4)


def select_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel body that runs ``flash_attention(q, k, v)`` on CUDA
    tensors, from dtypes, shapes, strides and data-pointer alignment alone
    (so CPU tensors give the same answer):

    - ``WGMMA``, the tensor-core body, for bfloat16 with dh a multiple of
      16 up to 128, every data pointer on a 16-byte boundary and every
      batch, head and sequence stride of q, k and v (of an axis longer
      than 1) a multiple of 16 bytes, as TMA requires;
    - ``SIMT``, the CUDA-core body, for everything else: float32 (tensor
      cores would need TF32, which cannot meet repro's fp32 1e-4 / 1e-5),
      other head dims, data TMA cannot address.

    A dispatch by dtype and shape: both bodies build, and a failing launch
    raises either way."""
    dh = q.shape[-1]
    if q.dtype != torch.bfloat16 or dh % 16 or dh > WGMMA_MAX_DH:
        return SIMT
    for t in (q, k, v):  # bf16: 16 bytes are 8 elements
        b, h, s, _ = t.shape
        sb, sh, ss, _ = t.stride()
        if t.data_ptr() % 16 or (b > 1 and sb % 8) or (h > 1 and sh % 8) or (s > 1 and ss % 8):
            return SIMT
    return WGMMA


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, device="cuda"):
    """q (B, H, S, dh), k and v (B, H_kv, S, dh) with H % H_kv == 0, all
    float32 or all bfloat16 → o (B, H, S, dh) in q's dtype: causal
    attention with fp32 scores times 1/√dh, -1e9 masking and an fp32
    online softmax whose p is rounded to v's dtype before p·v."""
    dev = resolve_device(device, meta=True)
    check_forward_only("flash_attention", q=q, k=k, v=v)
    check_on(dev, q=q, k=k, v=v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, H, S, dh) and k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (B, H_kv, S, dh)")
    B, H, S, dh = q.shape
    H_kv = k.shape[1]
    if k.shape != (B, H_kv, S, dh) or H % H_kv:
        raise ValueError(f"k/v {tuple(k.shape)} must be (B={B}, H_kv, S={S}, dh={dh}) "
                         f"with H={H} a multiple of H_kv")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dev.type != "cuda":
        # the body skips the tiles above the diagonal: about half the plain
        # version's products
        return ref.plain("flash_attention", ref.flash_attention_ref, q, k, v,
                         flops=2 * B * H * dh * S * (S + 1))
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head dim {dh} outside [1, {MAX_DH}]")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head-dim axis of q, k and v must be contiguous (stride 1)")
    return launch_body(q, k, v, select_body(q, k, v))


def launch_body(q, k, v, body: str) -> torch.Tensor:
    """Launch ``body`` (``WGMMA`` or ``SIMT``) on CUDA tensors that
    :func:`flash_attention` has checked (raises for a dtype neither body
    takes), and count the launch. The wrapper passes ``select_body``'s
    choice; ``chip_smoke.py`` also runs ``SIMT`` on bf16 inputs to time
    both bodies on the same data."""
    B, H, S, dh = q.shape
    code = _build.dtype_code(q)
    o = torch.empty_like(q)  # dense, with q's axis order (q's layout when q is dense)
    lib = _build.load("flash_attention")
    err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                              *o.stride()[:3], B, H, k.shape[1], S, dh, code, int(body == WGMMA),
                              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, body)
    if body == WGMMA:
        flash_attention.launches_wgmma += 1
    else:
        flash_attention.launches += 1
    return o


flash_attention.launches = 0
flash_attention.launches_wgmma = 0
