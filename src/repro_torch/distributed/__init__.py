"""Distribution: the sharding rules and pytree paths (:mod:`.sharding`),
the recovery ladder (:mod:`.fault_tolerance`) and elastic re-sharding
(:mod:`.elastic`) — port of :mod:`repro.distributed`."""
