"""Library services: the catalog, presets and the Lightroom preset converter."""
