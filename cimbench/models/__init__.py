"""Plain reference models, one module per family, found by the configuration's ``family``."""
