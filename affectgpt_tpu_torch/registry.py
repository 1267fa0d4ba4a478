"""Name → factory registry of the PyTorch port.

A copy of the parts of affectgpt_tpu/registry.py that the port uses: the
`lr_scheduler` namespace, which `training.optim` fills with its schedules,
the `dataset` namespace (`data.datasets`, `data.instruction_datasets`), the
`task` namespace (`training.runner.build_datasets`), the `runner`
namespace (`training.runner.Runner`) and the `model` namespace (the fusion
baselines of `toolkit.models`), and the `get` / `names` lookups. A
plain module-level table: registering resolves names only and holds no
state.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Dict[str, Callable]] = {
    ns: {} for ns in ("lr_scheduler", "dataset", "task", "runner", "model")}


def register(namespace: str, name: str) -> Callable:
    if namespace not in _REGISTRY:
        raise KeyError(f"Unknown registry namespace: {namespace}")

    def deco(obj):
        existing = _REGISTRY[namespace].get(name)
        if existing is not None and existing is not obj:
            raise KeyError(f"Duplicate registration: {namespace}/{name}")
        _REGISTRY[namespace][name] = obj
        return obj

    return deco


def get(namespace: str, name: str) -> Callable:
    try:
        return _REGISTRY[namespace][name]
    except KeyError:
        known = sorted(_REGISTRY.get(namespace, {}))
        raise KeyError(f"{namespace}/{name} not registered; known: {known}") from None


def names(namespace: str):
    return sorted(_REGISTRY[namespace])


def register_lr_scheduler(name):
    return register("lr_scheduler", name)


def register_dataset(name):
    return register("dataset", name)


def register_task(name):
    return register("task", name)


def register_runner(name):
    return register("runner", name)


def register_model(name):
    return register("model", name)
