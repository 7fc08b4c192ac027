"""Checkpointing: one ``.npy`` per leaf plus a manifest.

The JAX package's on-disk format, so a tree saved by either package
restores in the port: ``manifest.json`` (and ``manifest.msgpack`` where
``msgpack`` imports; it is not required) maps each leaf's key to its
file, shape and dtype.  Keys are the JAX package's key paths joined by
``/``: dict keys, list and tuple indices, and NamedTuple fields as
``.field`` (an ``AdamWState`` flattens to ``.step``, ``.m/embed``, ...);
file names put ``__`` for ``/``.

A bf16 leaf is written as the JAX package writes it: a ``<V2``
``.npy`` of the raw bf16 bits (numpy's header for JAX's bfloat16
dtype) with manifest dtype ``"bfloat16"``, byte for byte, with no
bfloat16 dtype in numpy.  It is read back by reinterpreting those bits
as ``torch.bfloat16``, with no cast through f32.  (The JAX package's
own restore cannot read such a file: numpy loads it as raw ``V2`` and
``astype`` finds no cast.)
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

try:
    import msgpack
    _HAVE_MSGPACK = True
except ImportError:  # pragma: no cover
    _HAVE_MSGPACK = False

_BF16_DESCR = "<V2"        # what np.save writes for JAX's bfloat16 arrays


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Iterator[Tuple[str, Any]]:
    """``(key, child)`` pairs as the JAX package's key paths name them;
    a leaf has none."""
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    if _is_namedtuple(tree):
        return ((f".{f}", getattr(tree, f)) for f in tree._fields)
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return iter(())


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_keys(tree: Any, prefix: str = ""
                      ) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` for every leaf, keyed as the checkpoint names it;
    ``None`` is an empty subtree, as in a JAX pytree."""
    if tree is None:
        return
    if not _is_node(tree):
        yield prefix, tree
        return
    for k, child in _children(tree):
        yield from flatten_with_keys(child, f"{prefix}/{k}" if prefix else k)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's host array and its manifest dtype; bf16 as its raw bits
    (int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_bf16(fn: Path, bits: np.ndarray) -> None:
    """``np.save`` of a JAX bfloat16 array, from its raw bits."""
    with open(fn, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": bits.shape})
        f.write(np.ascontiguousarray(bits).tobytes())


def save_checkpoint(path: str | Path, tree: Any, *, step: int = 0,
                    metadata: Optional[Dict[str, Any]] = None) -> Path:
    """Write every leaf of ``tree`` (tensors on any device, or arrays)
    under ``path``, with the manifest.  Returns ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, leaf in flatten_with_keys(tree):
        arr, dtype = _to_numpy(leaf)
        fn = key.replace("/", "__") + ".npy"
        if dtype == "bfloat16":
            _save_bf16(path / fn, arr)
        else:
            np.save(path / fn, arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": dtype}
    if _HAVE_MSGPACK:
        (path / "manifest.msgpack").write_bytes(
            msgpack.packb(manifest, use_bin_type=True))
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return path


def _load_leaf(fn: Path, info: Dict[str, Any]) -> torch.Tensor:
    arr = np.load(fn)
    if info["dtype"] == "bfloat16":
        # raw bf16 bits (``V2``): reinterpret, no cast
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(path: str | Path, like: Any,
                       device="cuda") -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (tensors, possibly on the
    meta device): each leaf's shape is checked (``ValueError`` on a
    mismatch), it is cast to the leaf's dtype where the file's differs,
    and placed on ``device``.  Returns ``(tree, step)``."""
    path = Path(path)
    mpath = path / "manifest.msgpack"
    if _HAVE_MSGPACK and mpath.exists():
        manifest = msgpack.unpackb(mpath.read_bytes(), raw=False)
    else:
        manifest = json.loads((path / "manifest.json").read_text())
    leaves = manifest["leaves"]

    def load(key: str, leaf) -> torch.Tensor:
        info = leaves[key]
        t = _load_leaf(path / info["file"], info)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"expected {tuple(leaf.shape)}")
        return t.to(device=device, dtype=leaf.dtype)

    def build(tree, prefix: str):
        if tree is None:
            return None
        if not _is_node(tree):
            return load(prefix, tree)
        kids = [build(c, f"{prefix}/{k}" if prefix else k)
                for k, c in _children(tree)]
        if isinstance(tree, dict):
            return dict(zip(tree.keys(), kids))
        if _is_namedtuple(tree):
            return type(tree)(*kids)
        return type(tree)(kids)

    return build(like, ""), int(manifest["step"])


def latest_checkpoint(root: str | Path) -> Optional[Path]:
    root = Path(root)
    if not root.exists():
        return None
    cands = sorted(p for p in root.iterdir()
                   if p.is_dir() and (p / "manifest.json").exists())
    return cands[-1] if cands else None
