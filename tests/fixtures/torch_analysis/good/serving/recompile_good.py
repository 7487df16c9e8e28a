"""Bucket helpers that clamp. Parsed, never run."""


def _pow2_bucket(n, hi):
    b = 1
    while b < n:
        b *= 2
    return min(b, hi)


def widths(ns, hi):
    return sorted({_pow2_bucket(n, hi) for n in ns})
