"""The matrix join backend's layout reductions: match_layout and sort_ranks."""
