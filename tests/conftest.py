import os

# Tests run on the CPU, on a virtual 8-device mesh; the GPU path is checked
# on a card by chip_smoke.py.  JAX_PLATFORMS alone does not stop a plugin
# that registers itself through jax.config, so the config value is set too,
# before any backend initializes.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
