"""gparml — sparse variational GPs and Bayesian GPLVM in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of markvdw/GParML
(see SURVEY.md): Titsias-collapsed sparse GP regression and Bayesian GPLVM,
data-parallel sufficient statistics over a device mesh, a fully jit'd SCG
optimizer, and fused GPU kernels for the psi-statistics hot loop.
"""

__version__ = "0.1.0"

from gparml import checkpoint, data
from gparml.models import gplvm, sgpr, svgp
from gparml.models import params
from gparml.opt import scg

__all__ = ["checkpoint", "data", "gplvm", "sgpr", "svgp", "params", "scg", "__version__"]
