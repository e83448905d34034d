"""The yardstick's frozen arithmetic: tower FLOPs, kernel bytes, card
peaks and the table layout a configuration implies."""
