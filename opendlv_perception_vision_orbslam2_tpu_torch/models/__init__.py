"""Pipeline stages of the ported slice (frame, extractor, front end, VO)."""
