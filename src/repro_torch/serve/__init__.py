"""Online serving of the port: the near-duplicate dedup service."""
