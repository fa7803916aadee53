"""Minimal donfig-compatible config object (a copy of graphblas_tpu/core/config.py).

The reference uses the ``donfig`` package for its two library-level options
(python-graphblas, graphblas/__init__.py:22-36 and graphblas.yaml).  donfig is not a
baked-in dependency here, so this module implements the subset of its API that
python-graphblas exposes: ``config.get``, ``config.set`` (usable as a context
manager), and mapping-style access.
"""

import contextlib
from collections.abc import MutableMapping


class Config(MutableMapping):
    def __init__(self, name, defaults=None, validators=None):
        self._name = name
        self._values = dict(defaults or {})
        self._validators = validators or {}

    def _check(self, key, value):
        if key not in self._values:
            raise KeyError(f"Unknown config key for {self._name}: {key!r}")
        validator = self._validators.get(key)
        if validator is not None and not validator(value):
            raise ValueError(f"Invalid value for {self._name} config {key!r}: {value!r}")

    def get(self, key, default=None):
        return self._values.get(key, default)

    @contextlib.contextmanager
    def _set_ctx(self, old):
        try:
            yield self
        finally:
            self._values.update(old)

    def set(self, arg=None, **kwargs):
        """Set config values; usable as a context manager like donfig."""
        updates = dict(arg or {})
        updates.update(kwargs)
        for key, value in updates.items():
            self._check(key, value)
        old = {k: self._values[k] for k in updates}
        self._values.update(updates)
        return self._set_ctx(old)

    # MutableMapping interface
    def __getitem__(self, key):
        return self._values[key]

    def __setitem__(self, key, value):
        self._check(key, value)
        self._values[key] = value

    def __delitem__(self, key):
        raise TypeError("Cannot delete config keys")

    def __iter__(self):
        return iter(self._values)

    def __len__(self):
        return len(self._values)

    def __repr__(self):
        return f"<{self._name} config {self._values!r}>"
