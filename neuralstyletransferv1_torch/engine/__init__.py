"""Pipeline engine: model bank, stylizer, batched video path, CLI."""
