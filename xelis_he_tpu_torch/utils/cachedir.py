"""Persistent-cache root resolution.

All disk caches (XLA compile cache, jax.export AOT modules, BP generator
tables, ECDLP tables) default to ``<repo>/.cache`` rather than
``~/.cache`` so they survive environment resets: a cold start of a
checkout finds the tables it built before.

Env overrides (highest wins):
  XELIS_CACHE_ROOT        root for everything below
  XELIS_HE_TPU_JAXCACHE   XLA persistent compile cache dir
  XELIS_CACHE_DIR         jax.export module dir (accel.py)
  XELIS_HE_TPU_CACHE      BP generator / ECDLP table dir
"""

import os
import pathlib


def cache_root() -> pathlib.Path:
    root = os.environ.get("XELIS_CACHE_ROOT")
    if root:
        return pathlib.Path(root)
    # utils/cachedir.py -> utils -> xelis_he_tpu_torch -> repo root
    repo = pathlib.Path(__file__).resolve().parent.parent.parent
    if os.access(repo, os.W_OK):
        # the port's own subtree: never beside the JAX package's committed
        # .cache/bpgens_*.bin files
        return repo / ".cache" / "torch"
    return pathlib.Path(os.path.expanduser("~/.cache/xelis_he_tpu_torch"))
