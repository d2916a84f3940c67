"""classpro_tpu — GPU-accelerated k-mer classification framework.

Re-implements the capabilities of ClassPro (Suzuki & Myers, WABI 2022)
as a JAX/XLA framework: every k-mer of every HiFi read is classified into one of four
states — Error / Haploid / Diplo / Repeat — from FASTK count profiles.

Layout
------
- ``classpro_tpu.io``       : FASTK ``.hist``/``.prof`` codecs, FASTA/FASTQ,
                              ``.class`` files  (ref: libfastk.c, kseq.h, io.c)
- ``classpro_tpu.numerics`` : Poisson/Skellam/Binomial log-probability kernels
                              (ref: prob.c, bessel.c, util.c)
- ``classpro_tpu.estimation``: global histogram → (H,D) coverage, error-model
                              threshold tables  (ref: hist.c, wall.c:44-244)
- ``classpro_tpu.context``  : per-base sequence context (ref: context.c)
- ``classpro_tpu.exact``    : bit-exact scalar reference engine (oracle)
- ``classpro_tpu.tpu``      : batched JAX production engine (device side)
- ``classpro_tpu.parallel`` : device-mesh data parallelism, multi-process psum
- ``classpro_tpu.tools``    : ClassGS / prof2class / class2acc / simulator
"""

__version__ = "0.1.0"

from classpro_tpu.constants import Defaults, State  # noqa: F401
