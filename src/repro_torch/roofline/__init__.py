"""Three-term roofline of the dry-run's records on the H100."""
