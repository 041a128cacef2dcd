"""The yardstick's counts: bytes and operations of a pruning sweep, and the
card's published peaks.

:func:`pruning_work`, :func:`loop_work` and :func:`bound` are frozen copies
of ``chip_smoke.py``'s (each input read once and each output written once;
2 S^2 + S operations per branch, category and pattern forward).
"""

from __future__ import annotations

# NVIDIA H100 SXM, published (data sheet, 700 W): device-memory bandwidth
# and the float32 rate of the CUDA cores, which is also the FP64
# tensor-core rate; the same peak serves float32 and float64
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12


def pruning_work(backward, T, I, C, S, maxc, P, itemsize):
    """(bytes, FLOPs) of one forward or backward sweep: each input read once
    and each output written once (forward: tips, pmats, rootw, children in;
    partials, scalers, site logs out; backward: tips, pmats, rootw,
    children, partials, scalers, cotangent in; d pmats, d rootw out), and
    2 S^2 + S operations per (branch, category, pattern) forward; backward
    6 S^2 + S above an internal node (the sibling's product again, the dP
    outer product, the child's cotangent) and 4 S^2 + S above a tip, which
    takes no cotangent; plus the rescaling and the root."""
    N = T + I
    pm, parts = N * C * S * S, I * C * S * P
    if backward:
        n = T * S * P + pm + C * S + parts + I * P + P + pm + C * S
        flops = P * (C * ((I - 1) * (6 * S * S + S) + T * (4 * S * S + S))
                     + 4 * C * S)
    else:
        n = T * S * P + pm + C * S + parts + I * P + P
        flops = P * ((N - 1) * C * (2 * S * S + S) + I * 2 * C * S
                     + 2 * C * S)
    return n * itemsize + 4 * I * (maxc + 1), flops


def loop_work(backward, T, I, C, S, maxc, P, L, itemsize):
    """(bytes, FLOPs) of one K5' or K6' launch over L chains: the function of
    the TPU loop kernel, which writes no partials (forward: tips once, and
    per chain pmats, freqs, props in, site logs out; backward: the same
    inputs and the cotangent in, d pmats, d freqs, d props out), and per
    chain the operations of :func:`pruning_work`."""
    N = T + I
    per_chain = N * C * S * S + S + C
    n = T * S * P + L * (per_chain + (P if backward else 0)
                         + (per_chain if backward else P))
    one = pruning_work(backward, T, I, C, S, maxc, P, itemsize)[1]
    return n * itemsize + 4 * I * maxc, L * one


def bound(nbytes, flops):
    """(least seconds, "bytes" or "operations") on the NVIDIA H100 SXM."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
