"""JSON model specs -> frozen dataclass configs (port of
rpagp/utils/config.py). The spec files in specs/ load unchanged."""

from __future__ import annotations

import dataclasses
import json
import math

import torch

from ..models.exact_gp import ModelSpec
from ..ops.kernels import KernelSpec


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.1
    max_iters: int = 1000
    patience: int = 20
    rel_tol: float = 1e-6
    lr_schedule: str = "constant"  # "constant" | "cosine" | "step"
    lr_decay_rate: float = 0.1  # cosine: final-lr fraction; step: decay x
    lr_decay_every: int = 0  # step schedule period (0 -> max_iters // 3)


def lr_factor(tr: TrainConfig):
    """step -> multiplier of tr.lr, the optax schedules of the JAX package
    (cosine_decay_schedule, staircase exponential_decay)."""
    if tr.lr_schedule == "constant":
        return lambda step: 1.0
    if tr.lr_schedule == "cosine":
        steps = max(1, tr.max_iters)
        a = tr.lr_decay_rate
        return lambda step: ((1.0 - a) * 0.5 * (
            1.0 + math.cos(math.pi * min(step, steps) / steps)) + a)
    if tr.lr_schedule == "step":
        every = tr.lr_decay_every or max(1, tr.max_iters // 3)
        return lambda step: tr.lr_decay_rate ** (step // every)
    raise ValueError(f"unknown lr_schedule {tr.lr_schedule!r}")


def make_optimizer(tr: TrainConfig, params):
    """(Adam, LambdaLR) over the leaf tensors `params` (optax's adam has the
    same bias-corrected update). Call the scheduler's step() after each
    optimizer step, as optax advances its count."""
    opt = torch.optim.Adam(params, lr=tr.lr)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(tr))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    model: ModelSpec
    train: TrainConfig
    name: str = "experiment"
    model_family: str = "exact_gp"  # "exact_gp" | "svgp"
    num_inducing: int = 512
    batch_size: int = 1024


def kernel_spec_from_dict(d: dict) -> KernelSpec:
    typ = d.get("type", "rbf")
    if typ in ("rbf", "matern12", "matern32", "matern52"):
        return KernelSpec(family=typ, ard=bool(d.get("ard", True)))
    if typ in ("rp_limit", "rp_limit_rbf", "limit"):
        return KernelSpec(family="rp_limit_rbf", ard=False)
    if typ in ("projection", "rp_poly", "polynomial_projection"):
        common = dict(
            proj_dist=d.get("proj_dist", "gaussian"),
            learn_proj=bool(d.get("learn_proj", False)),
            per_component_scale=bool(d.get("per_component_scale", False)),
            space_proj=bool(d.get("space_proj", False)),
            ski=bool(d.get("ski", False)),
            grid_size=int(d.get("grid_size", 0)),
            interp=str(d.get("interp", "dense")),
        )
        if "degrees" in d:
            bases = d.get("bases", ["rbf"] * len(d["degrees"]))
            return KernelSpec.generalized(d["degrees"], bases, **common)
        return KernelSpec.polynomial(J=int(d.get("J", 10)), d=int(d.get("d", 1)),
                                     k=int(d.get("k", 1)),
                                     base=d.get("base", "rbf"), **common)
    raise ValueError(f"unknown kernel type {typ!r}")


def experiment_spec_from_dict(d: dict, name: str = "experiment") -> ExperimentSpec:
    inf = d.get("inference", {})
    model = ModelSpec(
        kernel=kernel_spec_from_dict(d.get("kernel", {})),
        mean=d.get("mean", "constant"),
        max_cholesky_size=int(inf.get("max_cholesky_size", 4096)),
        cg_tol=float(inf.get("cg_tol", 1e-2)),
        cg_max_iters=int(inf.get("cg_max_iters", 100)),
        precond_rank=int(inf.get("precond_rank", 15)),
        num_probes=int(inf.get("num_probes", 10)),
        mvm_block_rows=int(inf.get("mvm_block_rows", 4096)),
        love_rank=int(inf.get("love_rank", 0)),
        precond_refresh=int(inf.get("precond_refresh", 1)),
        solver=str(inf.get("solver", "auto")),
        grid_jitter=float(inf.get("grid_jitter", 1e-6)),
    )
    tr = d.get("training", {})
    train = TrainConfig(
        lr=float(tr.get("lr", 0.1)),
        max_iters=int(tr.get("max_iters", 1000)),
        patience=int(tr.get("patience", 20)),
        rel_tol=float(tr.get("rel_tol", 1e-6)),
        lr_schedule=str(tr.get("lr_schedule", "constant")),
        lr_decay_rate=float(tr.get("lr_decay_rate", 0.1)),
        lr_decay_every=int(tr.get("lr_decay_every", 0)),
    )
    return ExperimentSpec(model=model, train=train, name=d.get("name", name),
                          model_family=d.get("model", "exact_gp"),
                          num_inducing=int(d.get("num_inducing", 512)),
                          batch_size=int(d.get("batch_size", 1024)))


def load_spec(path: str) -> ExperimentSpec:
    with open(path) as f:
        d = json.load(f)
    name = path.rsplit("/", 1)[-1].removesuffix(".json")
    return experiment_spec_from_dict(d, name=name)
