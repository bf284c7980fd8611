"""Device selection, error types and static-shape bucketing."""
