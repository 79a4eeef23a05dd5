"""alevin-fry-tpu: a single-cell quantification engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
COMBINE-lab/alevin-fry (reference v0.16.2): RAD file processing,
permit-list generation, barcode correction, collation, UMI resolution
(trivial / cr-like / cr-like-em / parsimony[-gene][-em]), per-cell
gene-level EM with USA mode and bootstraps, eqc-count inference, and the
scATAC-seq path (permit-list / collate / sort / deduplicate).

The compute path is JAX (device sort / segment ops / batched EM); the
byte-level RAD codec is native C++ (csrc/radc.cpp) with a pure-NumPy
fallback.  See SURVEY.md at the repository root for the structural
analysis of the reference that this package is built against.
"""

from . import _host_tuning

_host_tuning.apply()

# We re-implement the on-disk behavior of alevin-fry v0.16.2; stage
# metadata version-compatibility checks (utils.rs:1096-1142 in the
# reference) compare major.minor, so we advertise the same version to
# allow mixing stages with the reference tool.
__version__ = "0.16.2"
