"""batch, externalTimeBatch (A[K]) and lossyFrequent (E[K]) with a slot
axis in a tenant pool's chain against the reference's TenantPool, on
the CPU, each behind a ``${...}`` filter (the batch windows at a cap of
64 rows, which the feed's chunks never fill): rows, whole stacked
states and ``emitted`` after every round, bit for bit
(test_torch_pool_windows2.py has the feed and the comparison)."""
import torch

from siddhi_tpu_torch.ops import windows2 as W2
from test_torch_pool_windows2 import STREAM, run_pool

torch.set_num_threads(1)

PREFIX = "pu"
TEMPLATE = STREAM + """
@info(name='bt') @cap(window.size='64')
from S[v < ${hi:double}]#window.batch()
select k, count() as n
insert into BtOut;
@info(name='etb') @cap(window.size='64')
from S[v < ${hi:double}]#window.externalTimeBatch(ets, 50 milliseconds)
select k, sum(v) as sv
insert all events into EtbOut;
@info(name='lossy')
from S[v < ${hi:double}]#window.lossyFrequent(0.1, 0.02, k)
select k, v
insert all events into LossyOut;
"""


def test_batch_kinds_and_lossy_in_a_pool_equal_the_reference():
    run_pool(TEMPLATE, PREFIX, (W2.BatchWindowOp,
                                W2.ExternalTimeBatchWindowOp,
                                W2.LossyFrequentWindowOp), advance=False)
