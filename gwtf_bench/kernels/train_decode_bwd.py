"""Kernel 8's work, the backward of kernel 7 from its saved coupling
inputs: each coupling's forward again (its hidden states were not
saved: 4 f^2 + 24 f), dW1 and W1^T dh2 of both heads (8 f^2 + 12 f),
dW2 and the FiLM terms (24 f), the input pass (36 f). It reads the saved
inputs (12 C B), dp0 and dlv (24 B), writes dp (12 B)."""


def work(K: int, B: int, N: int, C: int, f: int) -> dict:
    points = K * B * N
    return dict(flop=points * C * (12 * f * f + 96 * f),
                nbytes=points * (12 + 24 + 12 * C))
