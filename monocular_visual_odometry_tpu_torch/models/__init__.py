"""State records and the per-frame VO step."""
