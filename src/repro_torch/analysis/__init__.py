"""Roofline analysis of the port's dry run (``launch.dryrun``)."""
from repro_torch.analysis.hlo import collective_bytes
from repro_torch.analysis.roofline import roofline_terms, model_flops
