"""The port's dry run (`launch/dryrun.py`, `parallel/hloanalysis.py`,
`parallel/opcount.py`) against the live JAX package.

The reference runs in a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=8, as
tests/test_torch_parallel_collectives.py runs it; the port's cells run in
another subprocess, on a fake process group of 8 ranks (a fake group cannot
share a process with the gloo groups of other tests). Both start at once.

- HLO parser parity, exact: `hloanalysis.analyze_hlo`, `collective_profile`
  and `dryrun.parse_collectives` of the port equal the reference's on HLO
  text the reference compiles on a (2, 4) mesh (a `lax.scan`, whose while
  loop carries `known_trip_count`; a dot under elementwise work; a
  `lax.cond`; an all-gather and an all-reduce), and on an HLO fragment
  written here with an `all-gather-start`/`all-gather-done` pair (XLA on
  the CPU emits no async collectives);
- `pick_profile` and `seq_shard` equal the reference's for all 40 (arch,
  shape) pairs, without REPRO_PROFILE and with each of its values;
- a folded scan (`opcount.trips`) counts what the full loop counts: the
  same FLOPs and, within 0.1%, the same traffic, forward and backward;
- per-device cells on (data 2, model 4): the smoke configs of tinyllama,
  qwen2-moe, rwkv6 and jamba in train (B 8, S 64), prefill (B 2, S 64:
  the batch over `data`, the sequence over `model`, as at full size) and
  decode (B 8 against a 64-token cache). `memory.argument_bytes` equals
  the reference's `memory_analysis().argument_size_in_bytes` exactly, and
  `flops` is within 2% (prefill, decode) or 5% (train) of the reference's
  `analyze_hlo` FLOPs. The MoE smoke config pads its 6 experts to 8 in
  both packages (`ep_pad_to=4`), since both expert-parallel bodies split
  the experts over the 4 `model` ranks.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import (ARCH_IDS, SHAPE_NAMES, get_config,
                                 get_shape)
from repro_torch.launch import dryrun
from repro_torch.parallel import hloanalysis

SRC = str(Path(__file__).resolve().parent.parent / "src")
TIMEOUT = 600
ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "rwkv6-3b", "jamba-v0.1-52b")
# mode -> (seq_len, global_batch)
MODES = {"train": (64, 8), "prefill": (64, 2), "decode": (64, 8)}
FLOPS_RTOL = {"train": 0.05, "prefill": 0.02, "decode": 0.02}
CELLS = [(a, m) for a in ARCHS for m in MODES]
PROFILES = (None, "2d", "fsdp", "tp")
# cells whose scans run folded and in full (4 chunks of 16, 16 positions,
# under remat "full")
UNFOLDED = [("rwkv6-3b", "train"), ("jamba-v0.1-52b", "train")]

# an async all-gather as XLA emits it on the TPU: the -start op's type is
# the (operand, result) tuple, the -done op carries the result
ASYNC_HLO = """HloModule async_gather, entry_computation_layout={(f32[4,8]{1,0})->f32[16,8]{1,0}}

%body (p: (s32[], f32[4,8])) -> (s32[], f32[4,8]) {
  %p = (s32[], f32[4,8]{1,0}) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[4,8]{1,0}) %p), index=0
  %x = f32[4,8]{1,0} get-tuple-element((s32[], f32[4,8]{1,0}) %p), index=1
  %ars = f32[4,8]{1,0} all-reduce-start(f32[4,8]{1,0} %x), channel_id=2, replica_groups={{0,1,2,3}}, to_apply=%add
  %ard = f32[4,8]{1,0} all-reduce-done(f32[4,8]{1,0} %ars)
  ROOT %t = (s32[], f32[4,8]{1,0}) tuple(s32[] %i, f32[4,8]{1,0} %ard)
}

%cond (p: (s32[], f32[4,8])) -> pred[] {
  %p = (s32[], f32[4,8]{1,0}) parameter(0)
  ROOT %c = pred[] constant(true)
}

ENTRY %main (p0: f32[4,8]) -> f32[16,8] {
  %p0 = f32[4,8]{1,0} parameter(0)
  %z = s32[] constant(0)
  %init = (s32[], f32[4,8]{1,0}) tuple(s32[] %z, f32[4,8]{1,0} %p0)
  %w = (s32[], f32[4,8]{1,0}) while((s32[], f32[4,8]{1,0}) %init), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"3"}}
  %y = f32[4,8]{1,0} get-tuple-element((s32[], f32[4,8]{1,0}) %w), index=1
  %ags = (f32[4,8]{1,0}, f32[16,8]{1,0}) all-gather-start(f32[4,8]{1,0} %y), channel_id=1, replica_groups={{0,1,2,3}}, dimensions={0}, use_global_device_ids=true, metadata={op_name="jit(f)/all_gather"}
  ROOT %agd = f32[16,8]{1,0} all-gather-done((f32[4,8]{1,0}, f32[16,8]{1,0}) %ags)
}
"""

_REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
jax.devices()
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.configs as rc
from repro.configs.base import ShapeConfig
import repro.launch.dryrun as rd
from repro.parallel.hloanalysis import analyze_hlo, collective_profile

args = json.load(open(sys.argv[1]))
out = {"hlo": {}, "parsed": {}, "profiles": {}, "cells": {}}
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
sh = lambda *s: NamedSharding(mesh, P(*s))
x = jnp.ones((16, 32), jnp.float32)
w = jnp.ones((6, 32, 32), jnp.float32)

def scan(w, x):
    return jax.lax.scan(lambda h, wi: (jnp.tanh(h @ wi), None), x, w)[0]

def dot(a, b):
    return jnp.exp(a @ b.T) * 2.0 + 1.0

def cond(a):
    return jax.lax.cond(a.sum() > 0, lambda v: v @ v.T, lambda v: -v @ v.T, a)

def coll(a):
    return a.sum(axis=1), a * 2.0

fns = {
    "scan": jax.jit(scan, in_shardings=(sh(), sh("data", None)),
                    out_shardings=sh("data", None)).lower(w, x),
    "dot": jax.jit(dot, in_shardings=(sh("data", None), sh("model", None)),
                   out_shardings=sh("data", "model")).lower(x, x),
    "cond": jax.jit(cond, in_shardings=(sh("data", None),),
                    out_shardings=sh()).lower(x),
    "collectives": jax.jit(coll, in_shardings=(sh("data", "model"),),
                           out_shardings=(sh(), sh())).lower(x),
}
for name, lowered in fns.items():
    out["hlo"][name] = lowered.compile().as_text()
out["hlo"]["async"] = args["async"]
for name, text in out["hlo"].items():
    out["parsed"][name] = {"analyze": analyze_hlo(text),
                           "profile": collective_profile(text),
                           "collectives": rd.parse_collectives(text)}

for env in args["profiles"]:
    if env is None:
        os.environ.pop("REPRO_PROFILE", None)
    else:
        os.environ["REPRO_PROFILE"] = env
    for arch in rc.ARCH_IDS:
        cfg = rc.get_config(arch)
        seq = (cfg.moe is None and (cfg.is_attention_free
               or cfg.num_kv_heads < cfg.num_heads
               or cfg.param_count() < 1e9))
        for s in rc.SHAPE_NAMES:
            out["profiles"][f"{env}/{arch}/{s}"] = [
                rd.pick_profile(cfg, rc.get_shape(s)), seq]
os.environ.pop("REPRO_PROFILE", None)

for arch, mode, seq, batch in args["cells"]:
    cfg = rc.get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_pad_to=4))
    rd.get_config = lambda a, cfg=cfg: cfg
    rd.get_shape = lambda n, m=mode, s=seq, b=batch: ShapeConfig("t", m, s, b)
    fn, fargs, ctx = rd.build_cell(arch, "t", mesh)
    comp = fn.lower(*fargs).compile()
    out["cells"][f"{arch}/{mode}"] = {
        "flops": analyze_hlo(comp.as_text())["flops"],
        "argument_bytes": comp.memory_analysis().argument_size_in_bytes,
        "profile": ctx.profile}
json.dump(out, open(args["out"], "w"))
"""

_PORT = r"""
import dataclasses, json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_ranks

args = json.load(open(sys.argv[1]))
init_fake_ranks(8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                  mesh_dim_names=("data", "model"))
out = {}
for arch, mode, seq, batch in args["cells"]:
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_pad_to=4))
    cell = dryrun.build_cell(arch, "t", mesh, device="cpu", cfg=cfg,
                             shape=ShapeConfig("t", mode, seq, batch))
    rec = dryrun.count_step(cell)
    out[f"{arch}/{mode}"] = {"flops": rec["flops"],
                             "argument_bytes": rec["memory"]["argument_bytes"],
                             "traffic_bytes": rec["traffic_bytes"],
                             "profile": cell.ctx.profile}
    if [arch, mode] in args["unfolded"]:
        rec = dryrun.count_step(cell, fold_loops=False)
        out[f"{arch}/{mode}/unfolded"] = {
            "flops": rec["flops"], "traffic_bytes": rec["traffic_bytes"]}
json.dump(out, open(args["out"], "w"))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference, port): both subprocesses, run at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    cells = [[a, m, *MODES[m]] for a, m in CELLS]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = {}
    for side, code, extra in (
            ("reference", _REFERENCE, {"async": ASYNC_HLO,
                                       "profiles": list(PROFILES)}),
            ("port", _PORT, {"unfolded": [list(c) for c in UNFOLDED]})):
        spec = tmp / f"{side}.json"
        spec.write_text(json.dumps({"cells": cells,
                                    "out": str(tmp / f"{side}-out.json"),
                                    **extra}))
        procs[side] = subprocess.Popen(
            [sys.executable, "-c", code, str(spec)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for side, p in procs.items():
        _, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, f"{side}: {err[-4000:]}"
        out[side] = json.loads((tmp / f"{side}-out.json").read_text())
    return out["reference"], out["port"]


@pytest.mark.parametrize("name", ["scan", "dot", "cond", "collectives",
                                  "async"])
def test_hlo_parsers_match_the_reference(results, name):
    ref, _ = results
    text, want = ref["hlo"][name], ref["parsed"][name]
    assert hloanalysis.analyze_hlo(text) == want["analyze"]
    assert hloanalysis.collective_profile(text) == want["profile"]
    assert dryrun.parse_collectives(text) == want["collectives"]


def test_the_texts_reach_every_path(results):
    """The loop is weighed by its trip count, the collectives are found,
    and the async pair is counted once, at half the -start tuple."""
    ref, _ = results
    hlo = ref["hlo"]
    assert '"known_trip_count"' in hlo["scan"]
    assert "conditional" in hlo["cond"]
    coll = hloanalysis.analyze_hlo(hlo["collectives"])["collectives"]
    assert coll.get("all-reduce", 0) > 0 and coll.get("all-gather", 0) > 0
    got = hloanalysis.analyze_hlo(ASYNC_HLO)["collectives"]
    assert got == {"all-reduce": 3 * 128 // 2, "all-reduce_count": 3.0,
                   "all-gather": (128 + 512) // 2, "all-gather_count": 1.0}
    assert dryrun.parse_collectives(ASYNC_HLO) == {
        "all-reduce": 128, "all-reduce_count": 1,
        "all-gather": 128, "all-gather_count": 1}


@pytest.mark.parametrize("env", PROFILES, ids=lambda e: str(e))
def test_pick_profile_and_seq_shard_match_the_reference(results, env,
                                                        monkeypatch):
    ref, _ = results
    if env is None:
        monkeypatch.delenv("REPRO_PROFILE", raising=False)
    else:
        monkeypatch.setenv("REPRO_PROFILE", env)
    n = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in SHAPE_NAMES:
            got = [dryrun.pick_profile(cfg, get_shape(s)),
                   dryrun.seq_shard(cfg)]
            assert got == ref["profiles"][f"{env}/{arch}/{s}"], (arch, s)
            n += 1
    assert n == 40


@pytest.mark.parametrize("arch,mode", CELLS)
def test_argument_bytes_equal_the_reference(results, arch, mode):
    ref, port = results
    key = f"{arch}/{mode}"
    assert port[key]["profile"] == ref["cells"][key]["profile"]
    assert port[key]["argument_bytes"] == ref["cells"][key]["argument_bytes"]


@pytest.mark.parametrize("arch,mode", CELLS)
def test_flops_match_the_reference(results, arch, mode):
    ref, port = results
    key = f"{arch}/{mode}"
    want = ref["cells"][key]["flops"]
    assert want > 0
    assert abs(port[key]["flops"] / want - 1) <= FLOPS_RTOL[mode], (
        port[key]["flops"], want)


@pytest.mark.parametrize("arch,mode", UNFOLDED)
def test_a_folded_scan_counts_the_whole_loop(results, arch, mode):
    _, port = results
    folded, full = port[f"{arch}/{mode}"], port[f"{arch}/{mode}/unfolded"]
    assert folded["flops"] == full["flops"]
    assert abs(folded["traffic_bytes"] / full["traffic_bytes"] - 1) < 1e-3
