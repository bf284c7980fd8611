"""Engines and the cascade orchestrator."""
