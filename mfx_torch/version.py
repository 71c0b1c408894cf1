__version__ = "0.5.0"  # the reference's (mfx/version.py)
