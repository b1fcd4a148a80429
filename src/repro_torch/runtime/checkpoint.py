"""Checkpoint manager: atomic, keep-last-k, async-capable
(``repro.runtime.checkpoint`` in PyTorch).

Layout (one directory per step):
    <dir>/step_000000123.tmp/...   (written first)
    <dir>/step_000000123/          (atomic rename commit)
        manifest.json              (leaf paths, dtypes, shapes, step, extra)
        shard_000.npz              (flat leaf arrays)

A state is a tree of dicts, ``nn.Module``s (their named parameters) and
leaves (tensors, or ints such as the step counter).  numpy has no bfloat16:
a bfloat16 tensor is stored as its raw 16-bit patterns (int16) with its
dtype in the manifest.  Restore copies every leaf back bit for bit into the
given state's tensors, on their device.  Async mode copies the state to
host memory before ``save`` returns and writes the files on a background
thread (one in flight).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
from torch import nn


def flatten_state(state, prefix: str = "") -> list:
    """[(path, leaf)] of ``state`` in a fixed order (dict insertion order,
    a module's ``named_parameters`` order)."""
    if isinstance(state, nn.Module):
        return [(prefix + name, p) for name, p in state.named_parameters()]
    if isinstance(state, dict):
        out = []
        for key, val in state.items():
            out += flatten_state(val, f"{prefix}{key}/")
        return out
    return [(prefix.rstrip("/"), state)]


def _to_host(leaf):
    """(numpy array, dtype name) of a leaf, copied off the live tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    return np.asarray(leaf), "int"


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = str(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, extra: dict | None = None):
        leaves = [(path, *_to_host(leaf)) for path, leaf in flatten_state(state)]
        if self.async_save:
            self.wait()                                    # one in flight
            self._thread = threading.Thread(target=self._write_async,
                                            args=(step, leaves, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, extra or {})

    def _write_async(self, step, leaves, extra):
        try:
            self._write(step, leaves, extra)
        except BaseException as e:       # handed to the next wait()
            self._error = e

    def _write(self, step, leaves, extra):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.directory, name + ".tmp")
        final = os.path.join(self.directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_000.npz"),
                 **{f"leaf_{i}": arr for i, (_, arr, _) in enumerate(leaves)})
        manifest = {"step": step, "n_leaves": len(leaves),
                    "leaves": [{"path": path, "dtype": dtype, "shape": list(arr.shape)}
                               for path, arr, dtype in leaves],
                    "time": time.time(), "extra": extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                              # atomic commit
        self._gc()

    def wait(self):
        """Wait for the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, state, step: int | None = None):
        """Copy checkpoint ``step`` (the latest by default) into ``state``'s
        tensors in place, bit for bit, on their devices; int leaves (the
        step counter) are set in their dicts.  Returns (state, manifest).
        Raises if the leaf paths, dtypes or shapes differ."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        manifest = self.manifest(step)
        ours = flatten_state(state)
        paths = [leaf["path"] for leaf in manifest["leaves"]]
        if paths != [path for path, _ in ours]:
            raise ValueError(f"checkpoint step {step}: its leaves do not match the state's")
        path = os.path.join(self.directory, f"step_{step:09d}")
        with np.load(os.path.join(path, "shard_000.npz")) as data, torch.no_grad():
            for i, ((name, leaf), meta) in enumerate(zip(ours, manifest["leaves"])):
                arr = data[f"leaf_{i}"]
                if not isinstance(leaf, torch.Tensor):
                    _set_path(state, name, int(arr))
                    continue
                t = _from_host(arr, meta["dtype"])
                if t.dtype != leaf.dtype or t.shape != leaf.shape:
                    raise ValueError(f"checkpoint step {step}: {name} is {t.dtype} "
                                     f"{tuple(t.shape)}, the state's {leaf.dtype} "
                                     f"{tuple(leaf.shape)}")
                leaf.copy_(t)
        return state, manifest

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step:09d}", "manifest.json")) as f:
            return json.load(f)


def _set_path(state: dict, path: str, value) -> None:
    *parents, last = path.split("/")
    for key in parents:
        state = state[key]
    state[last] = value
