"""The general traffic generators; a traffic file names one of them."""
