"""Serving: micro-batching of concurrent requests, the HTTP server
(``serve/app.py``, the one module of the port that imports werkzeug at module
level), and what it runs: rate limits, the video route, podcasts, audio links
and their URL fetcher, the resource monitor; and the split deployment: the
four model services (``model_services.py``) and their clients
(``clients.py``)."""
