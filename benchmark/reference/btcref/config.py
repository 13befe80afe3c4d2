"""Attribute-dict configurations for the reference."""

from __future__ import annotations

import copy


class EasyDict(dict):
    """dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, EasyDict):
            return EasyDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EasyDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EasyDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        del self[k]

    def get(self, k, default=None):
        return super().get(k, default)

    def __deepcopy__(self, memo):
        return EasyDict({k: copy.deepcopy(v, memo) for k, v in self.items()})
