"""Host-side helpers: units, validation, dtype policy."""
