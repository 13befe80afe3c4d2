"""Plain references for the port's tests."""
