"""The kinds of traffic, one module each, found by the `kind` that a mix
names: `port_bench/kinds/<kind>.py` holds its `Cell`, which harness.run
drives (see harness.py for the interface)."""
