"""Every subpackage of the port exports what the reference's exports,
under the same names, apart from the names that exist only for JAX."""

import importlib
import pkgutil

import pytest

import repro

SUBPACKAGES = sorted(m.name for m in pkgutil.iter_modules(repro.__path__) if m.ispkg)

# names of the reference with no counterpart in the port, by subpackage
JAX_ONLY = {
    # the Pallas kernels and their jnp oracles: the port's kernels are the
    # *_cuda wrappers, their oracles the plain versions beside them
    "kernels": {"ref", "flash_attention_pallas", "fused_aggregate_pallas", "relay_mix_pallas",
                "ssd_scan_pallas"},
    # jax.random key plumbing; the port's samplers take a torch.Generator
    "channel": {"channel_key"},
}
# reference name -> the port's name for the same job
RENAMED = {
    "ckpt": {"encode_prng_key": "encode_generator", "decode_prng_key": "decode_generator",
             "is_encoded_key": "is_encoded_generator"},
}


def test_every_reference_subpackage_is_listed():
    assert set(JAX_ONLY) | set(RENAMED) <= set(SUBPACKAGES) and "dist" not in JAX_ONLY
    assert {"channel", "checkpoint", "ckpt", "configs", "core", "data", "dist", "fl", "kernels",
            "launch", "models", "optim", "strategies", "telemetry", "wire"} == set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_the_reference_names(sub):
    ref = importlib.import_module(f"repro.{sub}")
    want = set(getattr(ref, "__all__", ())) - JAX_ONLY.get(sub, set())
    want = {RENAMED.get(sub, {}).get(name, name) for name in want}
    if not want:
        # no names exported (launch)
        return
    port = importlib.import_module(f"repro_torch.{sub}")
    exported = set(getattr(port, "__all__", ()))
    assert want <= exported, sorted(want - exported)
    missing = [name for name in exported if not hasattr(port, name)]
    assert not missing, missing
