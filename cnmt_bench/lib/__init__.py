"""The benchmark's machinery: traffic, the system under test, the window,
the check, the trace and the arithmetic of the bounds."""
