"""The one general generator: a fleet's shape from its traffic mix, and
its samples from the run's seed.

A mix file (``benchmark/mixes/<mix>.json``) gives:

* ``replica_weights``: P(r pods) ∝ weight ``r - 1`` (r = 1, 2, ...);
* ``full_pod_share``: the share of pods alive the whole window; the others
  hold a uniform 1 .. window samples (rollouts, scale-ups, restarts);
* ``shape_seed``: the seed of those sizes. Every run seed gets the same
  sizes, the containers in another order, so seeds change the values and
  never the amount of work.

A mix that needs code of its own adds ``benchmark/mixes/<mix>.py`` with
``pod_samples(mix, containers, window, rng) -> (replicas, pod_samples)``,
which replaces the default draw of the sizes.

Values follow the configuration's ``cpu_cores`` and ``memory_bytes``:
``level * (scale * u**power + offset)`` of a uniform ``u``, where each
container's ``level`` is log-uniform on [``level_low``, ``level_high``], so
containers differ in size as a fleet's do. All is drawn in float32 on the
run's device from a ``torch.Generator`` seeded by the run seed, and handed
over as float64 host arrays, as the fetch layer hands its samples.

A fleet's sample sets share one array per resource: set ``k`` is the draw
turned by ``k`` pod windows (its pods read the samples that lie one whole
pod further on, wrapping at the end), so each container reads other
samples, other containers' levels among them, and the host holds one
draw however many sets there are.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark import spec


@dataclass(frozen=True)
class Shape:
    """How many pods each container has, and how many samples each pod."""

    replicas: np.ndarray  # [containers] int64
    pod_samples: np.ndarray  # [pods] int64, pods in container order
    window: int  # samples of a pod alive the whole window

    @property
    def containers(self) -> int:
        return len(self.replicas)

    @property
    def row_samples(self) -> np.ndarray:
        """Samples of each container (its pods concatenated)."""
        starts = np.concatenate([[0], np.cumsum(self.replicas)[:-1]]).astype(np.int64)
        return np.add.reduceat(self.pod_samples, starts)


@dataclass(frozen=True)
class Samples:
    """One fleet's flat samples, pods in order, as float64 host arrays."""

    cpu: np.ndarray
    memory: np.ndarray


def _default_pod_samples(mix: dict, containers: int, window: int, rng: np.random.Generator):
    weights = np.asarray(mix["replica_weights"], dtype=np.float64)
    replicas = rng.choice(np.arange(1, len(weights) + 1), size=containers, p=weights / weights.sum())
    pods = int(replicas.sum())
    full = rng.random(pods) < mix["full_pod_share"]
    partial = rng.integers(1, window, endpoint=True, size=pods)
    return replicas, np.where(full, window, partial)


def _mix_hook(root: Path, mix_name: str):
    path = spec.mix_path(root, mix_name, ".py")
    if not path.exists():
        return _default_pod_samples
    module_spec = importlib.util.spec_from_file_location(f"benchmark_mix_{mix_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.pod_samples


def shape(config: dict, mix_name: str, mix: dict, seed: int, *, root: Path = spec.ROOT,
          containers: "int | None" = None) -> Shape:
    """The fleet's sizes: drawn from the mix's ``shape_seed``, containers
    permuted by ``seed``. ``containers`` overrides the configuration's
    count (small fleets for tests)."""
    count = int(config["containers"] if containers is None else containers)
    window = spec.samples_per_pod(config)
    replicas, lengths = _mix_hook(root, mix_name)(mix, count, window, np.random.default_rng(mix["shape_seed"]))
    replicas = np.asarray(replicas, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if len(replicas) != count or int(replicas.sum()) != len(lengths) or replicas.min() < 1:
        raise ValueError(f"mix {mix_name}: {len(replicas)} containers, {len(lengths)} pods, fewest pods {replicas.min()}")
    if len(lengths) and (lengths.min() < 1 or lengths.max() > window):
        raise ValueError(f"mix {mix_name}: a pod holds no samples or more than the window's {window}")
    order = np.random.default_rng(seed).permutation(count)
    starts = np.concatenate([[0], np.cumsum(replicas)[:-1]]).astype(np.int64)
    permuted = replicas[order]
    first = np.cumsum(permuted) - permuted
    pod_index = np.repeat(starts[order], permuted) + (np.arange(int(permuted.sum())) - np.repeat(first, permuted))
    return Shape(replicas=permuted, pod_samples=lengths[pod_index], window=window)


def set_shift(fleet: Shape) -> int:
    """Samples by which each sample set is turned from the one before."""
    return min(fleet.window, int(fleet.pod_samples.sum()))


def samples(config: dict, fleet: Shape, seed: int, device: str, sets: int) -> list[Samples]:
    """``sets`` sample sets of every pod (see the module docstring), drawn
    from one generator seeded by ``seed`` on ``device``, in a few large
    calls."""
    import torch

    total = int(fleet.pod_samples.sum())
    shift = set_shift(fleet)
    rows = torch.as_tensor(fleet.row_samples, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    def draw(law: dict) -> np.ndarray:
        low, high = np.log(float(law["level_low"])), np.log(float(law["level_high"]))
        levels = torch.rand(fleet.containers, generator=generator, device=device, dtype=torch.float32)
        levels = levels.mul_(high - low).add_(low).exp_()
        u = torch.rand(total, generator=generator, device=device, dtype=torch.float32)
        u.pow_(float(law["power"])).mul_(float(law["scale"])).add_(float(law["offset"]))
        u.mul_(levels.repeat_interleave(rows, output_size=total))
        extra = shift * (sets - 1)  # the later sets' wrap-around
        turned = torch.cat([u] * (1 + extra // total) + [u[: extra % total]])
        return turned.to(torch.float64).cpu().numpy()

    cpu, memory = draw(config["cpu_cores"]), draw(config["memory_bytes"])
    return [Samples(cpu=cpu[k * shift : k * shift + total], memory=memory[k * shift : k * shift + total])
            for k in range(sets)]
