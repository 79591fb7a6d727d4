"""IGEV-Stereo and its DiffuVolume variant: ``model.py`` (module path),
``gev_fold.py`` (the folded GEV tower), ``extractor.py``, ``update.py``,
``geometry.py``."""
