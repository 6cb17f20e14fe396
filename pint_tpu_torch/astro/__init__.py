"""The TOA prepare's astronomy: time scales, clock chains, observatories,
Earth orientation (K4's twin) and the analytic solar-system ephemeris (K5's
twin); ``device_prepare`` wraps the two kernels."""
