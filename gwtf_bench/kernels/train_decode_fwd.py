"""Kernel 7's work: every point of the K components' B clouds through C
couplings of width f (`work.coupling_flop`). It reads the points (12 B)
and the decoder's statistics' inputs, writes p0 and the logvar sums
(24 B) and each coupling's input, which the backward reads (12 C B)."""

from gwtf_bench.work import coupling_flop


def work(K: int, B: int, N: int, C: int, f: int) -> dict:
    points = K * B * N
    return dict(flop=points * C * coupling_flop(f),
                nbytes=points * (12 + 24 + 12 * C))
