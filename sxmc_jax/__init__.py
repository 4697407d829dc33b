"""sxmc_jax — signal-extraction framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
mastbaum/sxmc: unbinned maximum-likelihood signal extraction with binned
PDFs built from Monte-Carlo samples, on-the-fly systematic
transformations, adaptive-Metropolis (and gradient-based) MCMC, and
frequentist/credible interval estimation — with chains, fake experiments,
and the event dimension sharded over a device mesh.
"""

__version__ = "0.1.0"

from sxmc_jax.ops import transforms, histogram, nll  # noqa: F401
from sxmc_jax.pdf.evalhist import EvalHist, PdfError  # noqa: F401
from sxmc_jax.utils import ConfigError, FitError  # noqa: F401
