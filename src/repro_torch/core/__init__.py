"""Host core of the PyTorch port (sets, trees, measures, planner, driver)."""
