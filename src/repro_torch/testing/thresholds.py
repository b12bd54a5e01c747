"""Tolerances and thresholds for checks of the kernels.

Tie-safe pruning thresholds for ``lasso_prune``: two correct row-norm
computations that sum in another order differ in their last bits, so a
threshold within that noise of a norm can put the row on either side. A
check that demands equal masks therefore takes its threshold from a gap
between adjacent norms.

The per-element limit on ``flash_attention`` against its plain version
(:func:`flash_attention_limit`) follows from the one rounding the kernel
does that the plain version does not."""
from __future__ import annotations

import numpy as np
import torch

# 8 fp32 ulps at 1.0, relative: four times the largest kernel-vs-plain norm
# error seen at full width (one ulp at d 1536) on each side of the midpoint
FP32_SAFE_GAP = 8 * 2.0 ** -23


def gamma_between(norms, mask, q: float, rel_gap: float = 1e-4) -> float:
    """A threshold near the q-quantile of the alive rows' norms: the
    midpoint of the nearest pair of adjacent sorted alive norms whose gap
    is at least ``rel_gap`` of the larger one, so no norm lies within
    ``rel_gap / 2`` of it. ``norms`` and ``mask`` are (K, N) tensors or
    arrays. Raises ``ValueError`` if no such gap exists."""
    norms, mask = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
                   for x in (norms, mask))
    v = torch.sort(norms[mask.to(norms.device, torch.bool)].double()).values.cpu().numpy()
    ok = np.nonzero(v[1:] - v[:-1] >= rel_gap * v[1:])[0]
    if not ok.size:
        raise ValueError(f"no two adjacent alive-row norms lie {rel_gap:g} apart (relative)")
    j = ok[np.argmin(np.abs(ok - q * (len(v) - 1)))]
    return float((v[j] + v[j + 1]) / 2)


def flash_attention_limit(q, k, v, want):
    """Per-element limit on |kernel − plain| for ``flash_attention`` on
    (q, k, v), where ``want`` is the plain version's output.

    fp32: ``repro``'s own rtol 1e-4 / atol 1e-5 (tests/test_kernels.py:56).
    bf16: the kernel rounds each p to bf16 before p·v (relative error at
    most 2^-8 per term) and the plain version does not, so before their
    own output rounding the two differ by at most 2^-8·(softmax(s)·|v|)
    per element; the plain version computes that term on |v|. Each output
    then rounds to bf16 (at most 2^-8 of its magnitude), together 2^-7·|want|
    to first order. Both sides sum S fp32 terms in different orders, at most
    S·2^-24 relative each, on the same softmax(s)·|v| scale."""
    from repro_torch.kernels.ref import flash_attention_ref

    want = want.float()
    if q.dtype == torch.float32:
        return 1e-5 + 1e-4 * want.abs()
    S = q.shape[2]
    a = flash_attention_ref(q.float(), k.float(), v.abs().float())
    return (2.0 ** -8 + 2 * S * 2.0 ** -24) * a + 2.0 ** -7 * want.abs()
