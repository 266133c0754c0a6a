"""Plain float32 references that decide whether a run is correct."""
