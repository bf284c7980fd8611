"""Device selection and error types."""
