"""The harness: cell lookup, traffic, the system under test, the window, the
trace reduction, the work counts and the judge that decides ``correct``."""
