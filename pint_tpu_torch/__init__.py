"""pint_tpu_torch: the PyTorch/CUDA port of pint_tpu for NVIDIA Hopper.

The port mirrors the JAX package module by module (``pint_tpu_torch.X`` is
the counterpart of ``pint_tpu.X``) and imports nothing of it: the host
helpers it needs (constants, parfile parsing, exact decimal splitting) are
its own copies. Extended precision is double-double over IEEE float64, as in
``pint_tpu.ops.dd``; the device programs the TPU ran as fused XLA graphs are
hand-written CUDA kernels under ``csrc/`` (see ``pint_tpu_torch.ops.build``),
each with a plain-torch twin in the module that wraps it.

Every tensor is float64, set explicitly: torch turns Python floats into
float32 by default, which would silently drop the low half of every
double-double. Entry points take ``device=``; they run on CUDA unless the
caller asks for the CPU, and raise when no GPU is present and the CPU was
not asked for.
"""

__version__ = "0.1.0"

# --- fundamental constants (SI), the same public values as pint_tpu ----------
C_M_PER_S = 299792458.0  # speed of light, exact
AU_M = 149597870700.0  # IAU 2012 astronomical unit, exact
AU_LS = AU_M / C_M_PER_S  # AU in light-seconds ~ 499.004784
SECS_PER_DAY = 86400.0
DAYS_PER_JULIAN_YEAR = 365.25
SECS_PER_JULIAN_YEAR = SECS_PER_DAY * DAYS_PER_JULIAN_YEAR

# TEMPO-compatible dispersion constant, s MHz^2 / (pc cm^-3)
DMCONST = 1.0 / 2.41e-4

# Solar GM / c^3 "mass in time units" (seconds), DE440 heliocentric GM
GM_SUN = 1.32712440041279419e20  # m^3/s^2
TSUN_S = GM_SUN / C_M_PER_S**3

# IAU 2006 obliquity of the ecliptic at J2000, arcseconds
OBLIQUITY_J2000_ARCSEC = 84381.406

# integer MJD origin of the device-side dd seconds (pint_tpu.toas)
TENSOR_EPOCH_MJD = 55000

# planetary GM (m^3/s^2), DE440-family values, as in pint_tpu
GM_BODY = {
    "mercury": 2.2031868551e13,
    "venus": 3.24858592e14,
    "earth": 3.98600435507e14,
    "moon": 4.902800118e12,
    "mars": 4.2828375816e13,  # mars system
    "jupiter": 1.26712764100e17,  # jupiter system
    "saturn": 3.7940584841800e16,  # saturn system
    "uranus": 5.794556400e15,
    "neptune": 6.8365271005800e15,
}
EARTH_MOON_MASS_RATIO = 81.3005682214972154
