"""Seconds of set-up spent in the calibration pass that picks the
requantisation shifts (``cimsim.functional.calibrate_shifts``)."""


def read(r):
    return r.setup_calibrate_s
