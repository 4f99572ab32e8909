"""Public extension API for plugin authors (strategies & formatters).

The port's copy of `krr_tpu/api/`: re-exports only, pointed at the port's
own registries, so a plugin written against ``krr_tpu.api`` targets the
port by changing the package name.
"""
