"""Shared device-step sentinel constants (port of
siddhi_tpu/ops/sentinels.py). Plain numpy scalars: they are host
values, turned into tensors only where a step needs them."""
import numpy as np

NEG_INF = np.int64(-(2 ** 62))
POS_INF = np.int64(2 ** 62)
I32_MAX = np.int32(2 ** 31 - 1)
I32_LO = -(2 ** 31) + 1

# sentinel for "row not placed in any slot" (keyed state, partitions)
NO_SLOT = np.int32(-1)
