"""Device selection, error types, static-shape bucketing and the component
registry."""
