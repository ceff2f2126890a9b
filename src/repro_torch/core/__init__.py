"""Core substrate of the port: tensor trees and the host archive."""
