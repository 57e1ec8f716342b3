"""Checkpoint save and restore with best-metric tracking, as ``torch.save``
files.

Counterpart of ``stereoformer_tpu/train/checkpoint.py``: a checkpoint is
saved every epoch as ``{net}_{round}_{epoch}_{epe:.3f}`` in the checkpoint
directory, and copied to ``model_best`` when its EPE is the best so far;
``--resume`` takes the one of the highest (round, epoch). Each file holds
the whole training state, as the JAX package's do: the model's
``state_dict`` (parameters and BatchNorm buffers), the AMSGrad state (count
and moments), the step and the meta (round, epoch, arch, EPE, step). A file
is written under a temporary name and renamed into place, so a file under
a checkpoint's name is always complete. Saves are synchronous: the state
is updated in place by the next step, so it is copied before the next
step in any case.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Optional

import torch

from .optim import AmsgradState
from .state import TrainState

_TMP = ".tmp."


def _atomic_save(obj, path: str) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}{_TMP}{os.getpid()}")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def save_checkpoint(ckpt_dir: str, state: TrainState, net_name: str,
                    round_idx: int, epoch: int, val_epe: float,
                    is_best: bool) -> str:
    """Save ``{net}_{round}_{epoch}_{epe:.3f}`` (and ``model_best`` when
    ``is_best``) under ``ckpt_dir``; returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"{net_name}_{round_idx}_{epoch}_{val_epe:.3f}"
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    opt = state.opt_state
    meta = {"round": round_idx, "epoch": epoch, "arch": net_name,
            "best_EPE": val_epe, "step": int(state.step)}
    _atomic_save({
        "model": _cpu(state.model.state_dict()),
        "opt_state": {"count": int(opt.count), "mu": _cpu(opt.mu),
                      "nu": _cpu(opt.nu), "nu_max": _cpu(opt.nu_max)},
        "step": int(state.step),
        "meta": meta,
    }, path)
    if is_best:
        best = os.path.join(ckpt_dir, "model_best")
        tmp = os.path.join(ckpt_dir, f".model_best{_TMP}{os.getpid()}")
        shutil.copyfile(path, tmp)
        os.replace(tmp, best)
    return path


def finalize_checkpoints() -> None:
    """Wait for every save to land. Saves here are synchronous, so every
    one has landed when ``save_checkpoint`` returns; this is the JAX
    training loop's last call, kept so that loop ports unchanged."""


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _check_matches(path: str, what: str, got: dict, want: dict) -> None:
    """Raise ``RuntimeError`` unless ``got`` has ``want``'s keys and
    shapes: checked before anything is loaded, so that a failed restore
    leaves the target as it was."""
    if sorted(got) != sorted(want):
        raise RuntimeError(f"{path}: the {what} keys do not match the model")
    for k, v in want.items():
        if tuple(got[k].shape) != tuple(v.shape):
            raise RuntimeError(f"{path}: {what}[{k}] has shape "
                               f"{tuple(got[k].shape)}, not {tuple(v.shape)}")


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Restore the model, the AMSGrad state and the step of ``target`` from
    the checkpoint at ``path``, in place, onto the model's device. Raises
    (``KeyError``, ``RuntimeError``) where the file holds no optimizer state
    or does not match the model; ``target`` is then unchanged."""
    ck = _load(path)
    opt = ck["opt_state"]
    params = dict(target.model.named_parameters())
    _check_matches(path, "model", ck["model"], target.model.state_dict())
    for m in ("mu", "nu", "nu_max"):
        _check_matches(path, m, opt[m], params)
    target.model.load_state_dict(ck["model"])

    def moments(m):
        return {k: opt[m][k].to(p.device) for k, p in params.items()}

    target.opt_state = AmsgradState(count=int(opt["count"]), mu=moments("mu"),
                                    nu=moments("nu"),
                                    nu_max=moments("nu_max"))
    target.step = int(ck["step"])
    return target


def restore_params(path: str, target: TrainState) -> TrainState:
    """Restore only the model (parameters and BatchNorm buffers) and the
    step, keeping ``target``'s optimizer state: for a checkpoint without
    optimizer state or from another optimizer's run. ``path`` is a port
    checkpoint, or a port or reference ``state_dict`` file
    (``weights.load_state_dict_file``), which has no step."""
    from ..weights import load_state_dict_file

    ck = _load(path)
    sd = ck["model"] if "model" in ck else load_state_dict_file(path)
    _check_matches(path, "model", sd, target.model.state_dict())
    target.model.load_state_dict(sd)
    target.step = int(ck.get("step", target.step))
    return target


def checkpoint_meta(path: str) -> dict:
    """round, epoch, ... of a checkpoint: its meta where it has one, else
    parsed from the ``{net}_{round}_{epoch}_{epe}`` name."""
    try:
        return dict(_load(path)["meta"])
    except (OSError, RuntimeError, KeyError, TypeError):
        m = re.search(r"_(\d+)_(\d+)_([0-9.]+)$", os.path.basename(path))
        if m:
            return {"round": int(m.group(1)), "epoch": int(m.group(2)),
                    "best_EPE": float(m.group(3).rstrip("."))}
        return {}


def _is_complete_checkpoint(path: str) -> bool:
    # a file still under its temporary name is never resumed from
    return os.path.isfile(path) and _TMP not in os.path.basename(path)


def latest_checkpoint(ckpt_dir: str, net_name: str) -> Optional[str]:
    """The complete checkpoint of ``net_name`` in ``ckpt_dir`` with the
    highest (round, epoch), or None."""
    pat = os.path.join(ckpt_dir, f"{net_name}_*_*_*")
    best: tuple[int, int] = (-1, -1)
    best_path = None
    for p in glob.glob(pat):
        if not _is_complete_checkpoint(p):
            continue
        m = re.fullmatch(rf"{re.escape(net_name)}_(\d+)_(\d+)_[0-9.]+",
                         os.path.basename(p))
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            if key > best:
                best, best_path = key, p
    return best_path
