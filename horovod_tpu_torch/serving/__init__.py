"""Decode serving: generation engine, scheduler, admission errors."""
