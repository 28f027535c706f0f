"""JSON-RPC 2.0 server, routes and client (HTTP + WebSocket)."""
