"""The systems under test, one module each, found by the name a
configuration file gives."""
