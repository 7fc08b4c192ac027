"""Package-level contracts of the PyTorch port.

* ``repro_torch`` and every submodule import without JAX, and no file of
  the port names the JAX package.
* Entry points run on ``cuda`` unless the caller asks for the CPU.
* The modules the port keeps as copies (paging, sampling keys, metrics)
  behave exactly like the JAX package's.
"""
import inspect
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import repro_torch
from repro.obs.metrics import MetricsRegistry as JMetrics
from repro.serving.paging import BlockPool as JBlockPool
from repro.serving.paging import PrefixCache as JPrefixCache
from repro.serving.paging import block_hash_chain as j_hash_chain
from repro.serving.sampling import request_key as j_request_key
from repro_torch.kernels import _build
from repro_torch.models.model import init_paged_pool
from repro_torch.models.transformer import init_params
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import ServingEngine
from repro_torch.serving.paging import (BlockPool, PrefixCache, PrefixEntry,
                                        block_hash_chain)
from repro_torch.serving.sampling import request_key

torch.set_num_threads(2)

PKG_DIR = Path(repro_torch.__file__).resolve().parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], prefix="repro_torch."))


def test_import_never_loads_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_submodules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(\n"
        "    k for k in sys.modules if k.split('.')[0] in ('jax', 'repro'))))\n")
    src = str(PKG_DIR.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=src))
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(_submodules()) >= 25


def test_no_file_of_the_port_names_the_jax_package():
    pattern = re.compile(
        r"\brepro\.|^\s*(import|from)\s+jax\b|\bimport repro\b", re.M)
    offenders = [str(p.relative_to(PKG_DIR))
                 for p in PKG_DIR.rglob("*")
                 if p.suffix in (".py", ".cu", ".cuh")
                 and pattern.search(p.read_text())]
    assert offenders == []


def test_entry_points_default_to_cuda():
    for fn in (ServingEngine.__init__, init_params, init_paged_pool):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_kernel_build_names_follow_the_sources():
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert [s.stem for s in sources] == ["flash_attn", "fused_ffn",
                                         "paged_decode_attn"]
    for src in sources:
        lib = _build.library_path(src)
        assert lib.parent == _build.BUILD_DIR
        assert lib.name.startswith(f"lib{src.stem}-") and lib.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the build directory is git-ignored
    root = PKG_DIR.parents[1]
    assert "build/" in (root / ".gitignore").read_text().splitlines()


# ---------------------------------------------------- copied modules ----
def test_request_key_and_hash_chain_match_reference():
    for seed, rid, consumed in [(0, 0, 0), (5, 17, 3), (2**40, 2**33, 9)]:
        np.testing.assert_array_equal(request_key(seed, rid, consumed),
                                      j_request_key(seed, rid, consumed))
    toks = np.random.default_rng(0).integers(0, 300, 64).astype(np.int32)
    assert block_hash_chain(toks, 16, salt=7) == j_hash_chain(toks, 16, salt=7)


def test_block_pool_and_prefix_cache_match_reference():
    """The same sequence of allocator operations leaves both pools in the
    same state."""
    pools = [(BlockPool(3, 12, 4, 16), PrefixCache(2)),
             (JBlockPool(3, 12, 4, 16), JPrefixCache(2))]
    toks = np.arange(16, dtype=np.int32)
    for pool, prefix in pools:
        ids = pool.alloc(4)
        for j, b in enumerate(ids):
            pool.assign(0, j, b)
        pool.dedup_slot_prefix(0, block_hash_chain(toks, 4))
        ids2 = pool.alloc(4)
        for j, b in enumerate(ids2):
            pool.assign(1, j, b)
        pool.dedup_slot_prefix(1, block_hash_chain(toks, 4))
        prefix.insert(prefix.key_of(toks, 0),
                      PrefixEntry(tuple(ids), None, {}, 16), pool)
        pool.release_slot(0)
        prefix.evict_for_blocks(10, pool)
    (a, _), (b, _) = pools
    np.testing.assert_array_equal(a.tables, b.tables)
    np.testing.assert_array_equal(a.refs, b.refs)
    assert (a.free_blocks, a.used_blocks, a.shared_blocks) == \
        (b.free_blocks, b.used_blocks, b.shared_blocks)


def test_metrics_registry_matches_reference():
    xs = np.random.default_rng(1).exponential(size=500).tolist()
    regs = [MetricsRegistry(), JMetrics()]
    for reg in regs:
        h = reg.histogram("engine.step_time_hist_s")
        e = reg.ewma("engine.step_time_s")
        for x in xs:
            h.observe(x)
            e.update(x)
        reg.counter("engine.steps").inc(len(xs))
    assert regs[0].snapshot() == regs[1].snapshot()
