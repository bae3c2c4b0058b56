"""Test session config.

NOTE: no XLA_FLAGS here by design — smoke tests and benches must see ONE
device.  Multi-device tests spawn subprocesses (tests/helpers.py) that set
--xla_force_host_platform_device_count before jax initializes.
"""
import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(_ROOT, "src"))
sys.path.insert(0, _ROOT)  # for tests.helpers / benchmarks.* imports

import jax
import pytest

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "speculative: self-speculative decode suite (tiered GLASS draft/verify "
        "+ state-invariant rollback checks); CI runs it as its own lane under "
        "SPEC_GLASS_MODE=fused and SPEC_GLASS_MODE=block_sparse",
    )
    config.addinivalue_line(
        "markers",
        "kernels: fused paged-attention kernel suite (kernel vs gather "
        "reference, T>1 parallel-verify bit-equality, pow2 bucket invariance, "
        "compiled-program churn); CI runs it as its own lane, excluded from "
        "tier-1",
    )
    config.addinivalue_line(
        "markers",
        "sampling: per-request generation API suite (SamplingParams counter-"
        "based PRNG, GlassParams densities, streaming RequestOutput, abort, "
        "EOS early finish); CI runs it as its own lane",
    )
    config.addinivalue_line(
        "markers",
        "prefix_cache: shared-prefix invariant suite (copy-on-write block "
        "tables, refcounted prefix cache, bit-identical warm-vs-cold "
        "prefill); CI runs it as its own lane under PREFIX_GLASS_MODE=fused "
        "and PREFIX_GLASS_MODE=block_sparse",
    )
    config.addinivalue_line(
        "markers",
        "cluster: replica-sharded serving suite (ClusterEngine global-queue "
        "dispatch, bit-identical cross-replica migration, swap-store cap, "
        "per-replica device placement); CI runs it as its own lane with "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8, excluded from "
        "tier-1",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the PyTorch port's CUDA kernels have no CPU "
        "mode); skips on hosts without one",
    )


# ATTN_MODE=paged_pallas reruns the whole serving corpus through the fused
# paged-attention kernel: every PagedEngine a test builds (unless it passes
# attn_mode itself) picks the mode up here.  Pure-recurrent families have no
# attention block table to fuse over and keep the gather default.
_ATTN_MODE = os.environ.get("ATTN_MODE", "gather")
if _ATTN_MODE != "gather":
    from repro.serve.engine import PagedEngine as _PagedEngine

    _orig_init = _PagedEngine.__init__

    def _attn_mode_init(self, model, params, *args, **kwargs):
        if "attn_mode" not in kwargs and getattr(model.cfg, "family", "") != "ssm":
            kwargs["attn_mode"] = _ATTN_MODE
        _orig_init(self, model, params, *args, **kwargs)

    _PagedEngine.__init__ = _attn_mode_init


@pytest.fixture(scope="session")
def rng():
    return jax.random.key(0)
