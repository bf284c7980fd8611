"""Serving: micro-batching of concurrent requests, the HTTP server
(``serve/app.py``, the one module of the port that imports werkzeug), and
what it runs: rate limits, the video route, podcasts, audio links and the
resource monitor."""
