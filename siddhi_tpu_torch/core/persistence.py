"""Checkpoint / restore (PyTorch port of siddhi_tpu/core/persistence.py):
snapshot every piece of runtime state to host bytes, store it by
revision, restore it bit-exact.

Reference mapping:
- SnapshotService.fullSnapshot (util/snapshot/SnapshotService.java:90-183)
                                          -> SiddhiAppRuntime.snapshot()
- PersistenceStore SPI (util/persistence/InMemoryPersistenceStore.java:33,
  FileSystemPersistenceStore.java:37)     -> the two store classes here
- persist()/restoreRevision()/restoreLastRevision()/clearAllRevisions()
  (core/SiddhiAppRuntimeImpl.java:677-755) -> same-named runtime methods

Every piece of runtime state is a pytree of torch tensors on the app's
device. A snapshot copies each tensor to the host as a numpy array
(``to_host``: a copy, never a view of live state) and pickles the tree;
restore builds fresh device tensors from it (the kernels update state
in place, so a restored tensor must never alias the payload). Payloads
are pure data: numpy arrays and scalars, containers, strings and
numbers, which is all the restricted unpickler admits; a torch tensor
in a payload is refused.

A port payload carries ``"port": "torch"``. The reference's payloads
have the same pickled form but other state layouts: ``restore`` refuses
them, and ``carry.snapshot_from_jax`` / ``carry.pool_snapshot_from_jax``
convert them. The snapshot also carries the string dictionary (codes in
device columns must decode identically after a process restart) and
the playback clock.
"""
from __future__ import annotations

import io
import os
import pickle
import threading
import time
from typing import Optional

import torch

SNAPSHOT_FORMAT = 1
PORT_MARK = "torch"


class PersistenceStore:
    """SPI: save/load/clear revisions for an app
    (util/persistence/PersistenceStore.java)."""

    def save(self, app_name: str, revision: str, data: bytes) -> None:
        raise NotImplementedError

    def load(self, app_name: str, revision: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_last_revision(self, app_name: str) -> Optional[str]:
        raise NotImplementedError

    def list_revisions(self, app_name: str) -> list[str]:
        """All revisions for an app, oldest first (the checkpoint
        supervisor walks this newest-first to fall back past corrupted
        snapshots)."""
        raise NotImplementedError

    def clear_all_revisions(self, app_name: str) -> None:
        raise NotImplementedError


class InMemoryPersistenceStore(PersistenceStore):
    """(InMemoryPersistenceStore.java:33)"""

    def __init__(self):
        self._lock = threading.Lock()
        self._revisions: dict[str, dict[str, bytes]] = {}

    def save(self, app_name, revision, data):
        with self._lock:
            self._revisions.setdefault(app_name, {})[revision] = data

    def load(self, app_name, revision):
        with self._lock:
            return self._revisions.get(app_name, {}).get(revision)

    def get_last_revision(self, app_name):
        with self._lock:
            revs = self._revisions.get(app_name)
            return sorted(revs)[-1] if revs else None

    def list_revisions(self, app_name):
        with self._lock:
            return sorted(self._revisions.get(app_name, ()))

    def clear_all_revisions(self, app_name):
        with self._lock:
            self._revisions.pop(app_name, None)


class FileSystemPersistenceStore(PersistenceStore):
    """One file per revision under base_dir/app_name/, written to a
    temporary file and renamed, so a crash mid-save never leaves a torn
    revision (FileSystemPersistenceStore.java:37)."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def _dir(self, app_name: str) -> str:
        return os.path.join(self.base_dir, app_name)

    def save(self, app_name, revision, data):
        d = self._dir(app_name)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{revision}.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(d, f"{revision}.snapshot"))

    def load(self, app_name, revision):
        path = os.path.join(self._dir(app_name), f"{revision}.snapshot")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def get_last_revision(self, app_name):
        revs = self.list_revisions(app_name)
        return revs[-1] if revs else None

    def list_revisions(self, app_name):
        d = self._dir(app_name)
        if not os.path.isdir(d):
            return []
        return sorted(f[:-len(".snapshot")] for f in os.listdir(d)
                      if f.endswith(".snapshot"))

    def clear_all_revisions(self, app_name):
        d = self._dir(app_name)
        if not os.path.isdir(d):
            return
        for f in os.listdir(d):
            if f.endswith(".snapshot"):
                os.remove(os.path.join(d, f))


_rev_lock = threading.Lock()
_last_rev_ms = 0


def new_revision(app_name: str) -> str:
    """Monotonic, sortable revision id ('<millis>_<appName>', as the
    reference's). Two persists inside one millisecond would collide on
    the wall clock alone, so the last issued millisecond is bumped
    forward when the clock has not advanced."""
    global _last_rev_ms
    with _rev_lock:
        ms = int(time.time() * 1000)
        if ms <= _last_rev_ms:
            ms = _last_rev_ms + 1
        _last_rev_ms = ms
    return f"{ms:015d}_{app_name}"


def dump_strings() -> list:
    """Snapshot the global string dictionary (codes -> strings)."""
    from .types import GLOBAL_STRINGS
    with GLOBAL_STRINGS._lock:
        return list(GLOBAL_STRINGS._to_str)


def load_strings(entries: list) -> None:
    """Merge a snapshot's string dictionary back, code-stable.

    After a process restart the table is (nearly) empty and the
    snapshot's codes re-occupy their slots. If this process already
    interned a different string at a conflicting code, the snapshot
    cannot be mapped: that is an operator error (restoring into a live,
    unrelated process) and raises."""
    from .types import GLOBAL_STRINGS as g
    with g._lock:
        for code, s in enumerate(entries):
            if code < len(g._to_str):
                cur = g._to_str[code]
                if cur != s:
                    raise ValueError(
                        f"string-table conflict at code {code}: snapshot "
                        f"has {s!r}, process has {cur!r} — restore into a "
                        "fresh process")
            else:
                g._to_str.append(s)
                if s is not None:
                    g._to_code[s] = code


def to_host(tree):
    """A state pytree with every torch tensor as a numpy copy (floats
    keep their bits; a bool tensor becomes a bool array). Containers are
    rebuilt; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def serialize(payload: dict) -> bytes:
    """A port payload as bytes: the snapshot format, the port's mark,
    and the payload with every tensor copied to numpy."""
    return pickle.dumps({"format": SNAPSHOT_FORMAT, "port": PORT_MARK,
                         **to_host(payload)},
                        protocol=pickle.HIGHEST_PROTOCOL)


class _SnapshotUnpickler(pickle.Unpickler):
    """Restricted unpickler: snapshot payloads are pure data (numpy
    arrays and scalars, containers, strings, numbers), so only numpy's
    reconstruction callables are allowed. A tampered revision file can
    then corrupt state but not execute code, and a payload that holds a
    torch tensor (``torch._utils._rebuild_tensor_v2``) is refused."""

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy._core.numeric", "_frombuffer"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy", "bool_"),
    }

    def find_class(self, module, name):
        # the exact allowlist and numpy.dtypes' dtype classes only: a
        # broader rule would admit numpy's file IO callables
        if (module, name) in self._ALLOWED or (
                module == "numpy.dtypes" and name.endswith("DType")):
            import importlib
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"snapshot refers to non-data callable {module}.{name} — "
            "refusing to unpickle (tampered or incompatible revision)")


def deserialize(data: bytes) -> dict:
    """Bytes -> payload (a port's or a reference's: both share the
    format; ``is_port_payload`` tells them apart)."""
    payload = _SnapshotUnpickler(io.BytesIO(data)).load()
    fmt = payload.get("format") if isinstance(payload, dict) else None
    if fmt != SNAPSHOT_FORMAT:
        raise ValueError(f"unsupported snapshot format {fmt!r}")
    return payload


def check_port_payload(payload: dict, what: str) -> None:
    """Raise for a reference (JAX package) payload: its state layouts
    are the reference's, and the carry converters translate them."""
    if payload.get("port") != PORT_MARK:
        fn = "carry.pool_snapshot_from_jax" if what == "pool" \
            else "carry.snapshot_from_jax"
        raise ValueError(
            f"this {what} snapshot was taken by the reference package "
            f"(siddhi_tpu), whose state layouts differ: convert it with "
            f"siddhi_tpu_torch.{fn} first")
