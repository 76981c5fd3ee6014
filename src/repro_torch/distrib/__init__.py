"""Scale-out of the port on ``torch.distributed``: collectives, fault
tolerance and sharding rules (counterpart of ``repro.distrib``)."""
from repro_torch.distrib import collectives, compat, fault, sharding

__all__ = ["collectives", "compat", "fault", "sharding"]
