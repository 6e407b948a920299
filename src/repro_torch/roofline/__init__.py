"""Roofline cost model of the port (port of ``repro.roofline``):
``analysis`` holds the H100 roofline terms and the collective summaries,
``op_cost`` the costs of an op trace."""
