"""The entropy calibration search of post-training int8 quantization
(the counterpart of ``optimal_threshold`` in
``mxtpu/contrib/quantization.py:113``, numpy on the host, copied line
for line so both packages pick the same threshold from the same
values).  ``mxtpu_torch.quant.EntropyCollector`` calls it."""
from __future__ import annotations

import numpy as np

__all__ = ["optimal_threshold"]


def optimal_threshold(arr, num_bins: int = 2001,
                      num_quantized_bins: int = 255) -> float:
    """KL-minimizing |x| threshold for int8 quantization — the
    reference's TensorRT-style entropy calibration."""
    # KL divergence sums tiny probabilities; f64 is the point here
    a = np.abs(np.asarray(arr, np.float64).ravel())
    amax = float(a.max()) if a.size else 0.0
    if amax < 1e-12:
        return 1e-6
    hist, edges = np.histogram(a, bins=num_bins, range=(0, amax))
    hist = hist.astype(np.float64)
    best_div = np.inf
    best_t = amax
    stride = max(1, (num_bins - num_quantized_bins) // 64)
    for i in range(num_quantized_bins, num_bins + 1, stride):
        p = hist[:i].copy()
        p[-1] += hist[i:].sum()  # outliers collapse into the clip bin
        psum = p.sum()
        if psum == 0:
            continue
        # quantize the first i bins to num_quantized_bins levels, then
        # expand back uniformly over the non-empty source bins: Q
        q = np.zeros(i)
        factor = i / num_quantized_bins
        for j in range(num_quantized_bins):
            lo = int(np.floor(j * factor))
            hi = min(int(np.ceil((j + 1) * factor)), i)
            chunk = hist[lo:hi]
            nz = int((chunk > 0).sum())
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        qsum = q.sum()
        if qsum == 0:
            continue
        pn = p / psum
        qn = q / qsum
        mask = pn > 0
        div = float(np.sum(np.where(
            mask, pn * np.log(np.maximum(pn, 1e-30) /
                              np.maximum(qn, 1e-30)), 0)))
        if div < best_div:
            best_div = div
            best_t = float(edges[min(i, len(edges) - 1)])
    return best_t
