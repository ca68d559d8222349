"""Operation and byte counts behind each roofline, from the inputs alone."""
