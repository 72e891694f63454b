"""Host-side utilities (port of siddhi_tpu/utils/)."""
