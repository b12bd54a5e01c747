"""Tie-safe pruning thresholds for checks of ``lasso_prune``.

Two correct row-norm computations that sum in another order differ in
their last bits, so a threshold within that noise of a norm can put the
row on either side. A check that demands equal masks therefore takes its
threshold from a gap between adjacent norms."""
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
