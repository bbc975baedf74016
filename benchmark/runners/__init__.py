"""The runners, one a kind of traffic: `train.py` (kind "train") and
`serve.py` (kinds "open_loop" and "closed_loop")."""
