"""Tools run by hand on the card when a cell's limits are set."""
