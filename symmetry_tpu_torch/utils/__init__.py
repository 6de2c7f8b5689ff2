"""Host-side utilities copied from `symmetry_tpu.utils`: logging, faults,
metrics, tracing and JSON. None of them touches the device."""
