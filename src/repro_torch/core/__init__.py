"""ColRel core: connectivity models, topologies and COPT-alpha (numpy,
copied from ``repro.core``), plus the flatten plumbing and the relay
algebra on tensors."""
