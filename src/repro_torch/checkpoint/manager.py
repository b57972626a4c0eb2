"""Disk checkpointing for cold restart, mirroring
``repro.checkpoint.manager`` (warm elastic events never touch disk: the
ring snapshot of ``core/fabric`` serves them).

Format, the reference's: ``step_%08d/`` holds one ``.npz`` per tree
(``params.npz``, ``opt.npz``) and ``manifest.json``, ``{step, arrays:
{name: {file, sha256}}, extra}``; a checkpoint is written to
``.tmp_step_%08d`` and renamed, and the oldest are removed so that
``keep`` remain.  Keys are the ``/``-joined path of dict keys and
list/tuple indices (``repro_torch.tree``: jax's order).

numpy has no bfloat16, so a bf16 leaf is stored losslessly as its 16 bits
(uint16) and its key listed under ``arrays[name]["bfloat16"]`` in the
manifest (the entry is there only when a tree has bf16 leaves, so a tree
of numpy arrays gives the reference's manifest); :meth:`restore` returns
those bits, and :meth:`restore_into` turns them back into bf16.

``save(..., blocking=False)`` copies every leaf to the host before it
returns (the port updates parameters and optimizer state in place, so a
copy taken later would race the next step) and writes the copies on a
background thread; :meth:`wait` joins it and raises what it raised.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths

BF16_KEY = "bfloat16"


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _host(leaf) -> Tuple[np.ndarray, bool]:
    """A host copy of ``leaf`` as numpy, and whether it holds bf16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.array(leaf), False


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], list]:
    flat, bf16 = {}, []
    for path, leaf in leaves_with_paths(tree):
        k = _key(path)
        flat[k], is_bf16 = _host(leaf)
        if is_bf16:
            bf16.append(k)
    return flat, bf16


def _sha256(fn: Path) -> str:
    return hashlib.sha256(fn.read_bytes()).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -------------------------------------------------------------- save --
    def save(self, step: int, params, opt_state=None, *, blocking=True,
             extra: Optional[Dict[str, Any]] = None):
        flats = {"params": _flatten(params)}
        if opt_state is not None:
            flats["opt"] = _flatten(opt_state)

        def _write():
            ckpt = self.dir / f"step_{step:08d}"
            tmp = self.dir / f".tmp_step_{step:08d}"
            tmp.mkdir(exist_ok=True)
            manifest = {"step": step, "arrays": {}, "extra": extra or {}}
            for name, (flat, bf16) in flats.items():
                fn = tmp / f"{name}.npz"
                np.savez(fn, **flat)
                manifest["arrays"][name] = {"file": f"{name}.npz",
                                            "sha256": _sha256(fn)}
                if bf16:
                    manifest["arrays"][name][BF16_KEY] = bf16
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if ckpt.exists():
                shutil.rmtree(ckpt)
            os.rename(tmp, ckpt)
            self._gc()

        def _write_recorded():
            try:
                _write()
            except BaseException as e:   # re-raised by wait()
                self._error = e
                raise

        self.wait()
        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_recorded,
                                            daemon=True)
            self._thread.start()

    def wait(self):
        """Join the background write, if any; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for c in sorted(self.dir.glob("step_*"))[:-self.keep]:
            shutil.rmtree(c)

    # ----------------------------------------------------------- restore --
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*"))
        return int(ckpts[-1].name.split("_")[1]) if ckpts else None

    def restore(self, step: Optional[int] = None, *, verify: bool = True,
                ) -> Tuple[int, Dict[str, Dict[str, np.ndarray]], Dict]:
        """(step, {tree name: {key: array}}, extra); a bf16 leaf's array
        holds its bits (uint16).  A file whose sha256 differs from the
        manifest's raises ``IOError``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        ckpt = self.dir / f"step_{step:08d}"
        manifest = json.loads((ckpt / "manifest.json").read_text())
        out = {}
        for name, meta in manifest["arrays"].items():
            fn = ckpt / meta["file"]
            if verify and _sha256(fn) != meta["sha256"]:
                raise IOError(f"checkpoint corrupted: {fn}")
            with np.load(fn) as z:
                out[name] = {k: z[k] for k in z.files}
        return manifest["step"], out, manifest.get("extra", {})

    def restore_into(self, tree, flat: Dict[str, np.ndarray]):
        """``tree`` with its leaves from ``flat``: a tensor leaf is
        overwritten in place, in its dtype and on its device (bf16 from
        its stored bits, bit for bit), so views of it see the restored
        values; a numpy leaf becomes a new array of its dtype, a Python
        number a number of its type.  Returns the tree
        (its tensors are the same objects)."""
        new = {}
        with torch.no_grad():
            for path, leaf in leaves_with_paths(tree):
                a = flat[_key(path)]
                if isinstance(leaf, torch.Tensor):
                    if leaf.dtype == torch.bfloat16 and a.dtype == np.uint16:
                        src = torch.from_numpy(a.view(np.int16)) \
                            .view(torch.bfloat16)
                    else:
                        src = torch.from_numpy(np.ascontiguousarray(a))
                    leaf.copy_(src.reshape(leaf.shape))
                elif isinstance(leaf, np.ndarray):
                    new[path] = a.astype(leaf.dtype)
                else:
                    new[path] = type(leaf)(a)
        return _replace(tree, new, ())


def _replace(tree, new: dict, prefix):
    """``tree`` with the leaves at the paths of ``new`` replaced."""
    if prefix in new:
        return new[prefix]
    if isinstance(tree, dict):
        return {k: _replace(v, new, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, new, prefix + (i,))
                          for i, v in enumerate(tree))
    return tree
