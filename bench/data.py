"""The benchmark's data: base vectors from a configuration's `data_seed`,
queries from a run's `--seed`.

The arithmetic is a copy of the stand-in generator of the port
(`repro_torch.core.dataset.make_dataset`): clustered points on a
low-dimensional nonlinear manifold, lifted to the data set's dimension and,
for integer-valued data sets, rounded into the integer range. A data set's
model (cluster centres, lift weights, integer scale) comes from the data
seed alone, so the base vectors are one fixed set per configuration, as a
public data set is one fixed file. Queries are fresh draws from the same
model with their own generator, so every seed gives new queries against the
same base.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

# name: (dimension, value type, clusters), as the port's stand-ins
SPECS = {
    "sift-like": (128, "uint8", 64),
    "deep-like": (96, "float", 64),
    "spacev-like": (100, "int8", 48),
    "gist-like": (960, "float", 32),
}


def seed_words(seed: int) -> list:
    """A run seed as SeedSequence words: any whole number, negative or
    beyond 64 bits included."""
    s = int(seed)
    words = [0 if s >= 0 else 1]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            return words


@dataclasses.dataclass
class DataModel:
    name: str
    dim: int
    value_type: str
    centers: np.ndarray
    w1: np.ndarray
    w2: np.ndarray
    scale: float = 1.0      # integer data sets: the rounding scale (f32)

    def _lift(self, rng, z):
        return (np.tanh(z @ self.w1) @ self.w2 + 0.05 * rng.normal(
            0, 1.0, (len(z), self.dim))).astype(np.float32)

    def _draw(self, rng, count):
        k_lat = self.centers.shape[1]
        z = self.centers[rng.integers(0, len(self.centers), count)] + \
            0.6 * rng.normal(0, 1.0, (count, k_lat)).astype(np.float32)
        return self._lift(rng, z)

    def quantize(self, x):
        if self.value_type == "float":
            return x
        lo, hi, off = ((0, 255, 128) if self.value_type == "uint8"
                       else (-128, 127, 0))
        return np.clip(np.round(x * self.scale + off), lo, hi).astype(
            np.float32)

    def queries(self, seed: int, count: int) -> np.ndarray:
        """`count` queries drawn from the run seed."""
        rng = np.random.default_rng([0x51] + seed_words(seed))
        return self.quantize(self._draw(rng, count))


def make_base(name: str, n: int, data_seed: int) -> tuple:
    """(base vectors (n, d) float32, DataModel), with the generator calls of
    `make_dataset` in its order."""
    dim, tag, n_clusters = SPECS[name]
    rng = np.random.default_rng(data_seed + zlib.crc32(name.encode()) % 10000)
    k_lat = int(np.clip(dim // 12, 8, 16))
    centers = rng.normal(0, 1.0, (n_clusters, k_lat)).astype(np.float32)
    w1 = rng.normal(0, 1.0, (k_lat, 4 * k_lat)).astype(np.float32) / np.sqrt(
        k_lat)
    w2 = rng.normal(0, 1.0, (4 * k_lat, dim)).astype(np.float32) / np.sqrt(
        4 * k_lat)
    model = DataModel(name, dim, tag, centers, w1, w2)
    x = model._draw(rng, n)
    if tag != "float":
        model.scale = 80.0 / max(np.abs(x).max(), 1e-6)
        x = model.quantize(x)
    return x, model
