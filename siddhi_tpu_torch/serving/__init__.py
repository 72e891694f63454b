"""Multi-tenant serving (PyTorch port of siddhi_tpu/serving/).

Every tenant of ONE query template shares one planned step set: the
template plans once (``${name:type}`` placeholders lower to per-tenant
parameter loads, not baked literals), per-tenant states stack on a
leading slot axis, and one launch sequence a query advances every
tenant of the template (serving/pool.py). Migration, rebalance and
evacuation (the reference's serving/migrate.py and rebalance.py) are not
ported yet.
"""
from .template import Template, TemplateRegistry
from .pool import AdmissionError, TenantPool
from .qos import CircuitBreaker, PoolQoS, TokenBucket

__all__ = ["Template", "TemplateRegistry", "TenantPool",
           "AdmissionError", "PoolQoS", "TokenBucket",
           "CircuitBreaker"]
