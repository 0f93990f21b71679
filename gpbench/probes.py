"""Counters read around the profiled unit, from the benchmark's side of
the calls into the kernel layer: the shape of every K2 call, so that its
roofline counts the work of the calls that ran. The wrapper records a
shape and calls through; it changes no work. A name the program no
longer has is left alone, and the metric that reads it stays silent."""

from __future__ import annotations

import importlib

# (module, function, recorded key): K2 (tfrac, V, m) calls
_WRAPPED = (("rpagp_torch.ops.cuda_interp", "interp_transpose_cuda",
             "k2_calls"),)


def _shape_k2(tfrac, V, m, *a, **kw):
    return (int(tfrac.shape[0]), int(tfrac.shape[1]), int(V.shape[1]),
            int(m))


_SHAPES = {"k2_calls": _shape_k2}


class Probes:
    def __init__(self):
        self.calls = {key: [] for _, _, key in _WRAPPED}
        self._saved = []

    def __enter__(self):
        for modname, fn, key in _WRAPPED:
            mod = importlib.import_module(modname)
            orig = getattr(mod, fn, None)
            if orig is None:
                continue

            def wrapper(*a, _orig=orig, _key=key, **kw):
                self.calls[_key].append(_SHAPES[_key](*a, **kw))
                return _orig(*a, **kw)

            setattr(mod, fn, wrapper)
            self._saved.append((mod, fn, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in reversed(self._saved):
            setattr(mod, fn, orig)
        return False

    def counters(self) -> dict:
        return dict(self.calls)
