"""What every cell shares: the catalog of cells, configurations, mixes and
metrics, the spans and the device trace, and the run itself."""
