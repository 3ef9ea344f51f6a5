"""Entry points: cli/runner.py (model construction, padded evaluation) and
the three demos, demo_middlebury, demo_hd720p and demo_vimeo_ve."""
