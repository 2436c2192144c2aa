"""One module a traffic kind, each with `run(...) -> ctx` (see run.py)."""
