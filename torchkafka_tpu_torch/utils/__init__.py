"""Host utilities: device selection and metrics."""
