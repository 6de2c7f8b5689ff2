"""Host-side utilities copied from `symmetry_tpu.utils`: logging, faults,
metrics and tracing. None of them touches the device."""
