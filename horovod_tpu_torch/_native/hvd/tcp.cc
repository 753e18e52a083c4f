#include "tcp.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <thread>

namespace hvd {

Socket::~Socket() { Close(); }

Socket& Socket::operator=(Socket&& o) noexcept {
  if (this != &o) {
    Close();
    fd_ = o.fd_;
    o.fd_ = -1;
  }
  return *this;
}

void Socket::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

bool Socket::Connect(const std::string& host, int port, double timeout_s) {
  auto deadline =
      std::chrono::steady_clock::now() +
      std::chrono::milliseconds(static_cast<int64_t>(timeout_s * 1000));
  struct addrinfo hints;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  std::string port_s = std::to_string(port);
  // retry loop: the coordinator may not be listening yet at worker start
  while (std::chrono::steady_clock::now() < deadline) {
    struct addrinfo* res = nullptr;
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0) {
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
      continue;
    }
    int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd >= 0 && ::connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
      freeaddrinfo(res);
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      Close();
      fd_ = fd;
      return true;
    }
    if (fd >= 0) ::close(fd);
    freeaddrinfo(res);
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  return false;
}

bool Socket::SendAll(const void* data, size_t len) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  while (len > 0) {
    ssize_t n = ::send(fd_, p, len, MSG_NOSIGNAL);
    if (n <= 0) return false;
    p += n;
    len -= n;
  }
  return true;
}

bool Socket::RecvAll(void* data, size_t len) {
  uint8_t* p = static_cast<uint8_t*>(data);
  while (len > 0) {
    ssize_t n = ::recv(fd_, p, len, 0);
    if (n <= 0) return false;
    p += n;
    len -= n;
  }
  return true;
}

bool Socket::SendFrame(const std::vector<uint8_t>& payload) {
  uint64_t len = payload.size();
  if (!SendAll(&len, sizeof(len))) return false;
  return payload.empty() || SendAll(payload.data(), payload.size());
}

bool Socket::RecvFrame(std::vector<uint8_t>* payload) {
  uint64_t len = 0;
  if (!RecvAll(&len, sizeof(len))) return false;
  if (len > (1ull << 33)) return false;  // sanity bound
  payload->resize(len);
  return len == 0 || RecvAll(payload->data(), len);
}

Listener::~Listener() { Close(); }

void Listener::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

bool Listener::Listen(int port) {
  fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd_ < 0) return false;
  int one = 1;
  setsockopt(fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    Close();
    return false;
  }
  if (::listen(fd_, 128) != 0) {
    Close();
    return false;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
  port_ = ntohs(addr.sin_port);
  return true;
}

Socket Listener::Accept(double timeout_s) {
  struct pollfd pfd = {fd_, POLLIN, 0};
  int r = ::poll(&pfd, 1, static_cast<int>(timeout_s * 1000));
  if (r <= 0) return Socket();
  int cfd = ::accept(fd_, nullptr, nullptr);
  if (cfd < 0) return Socket();
  int one = 1;
  setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return Socket(cfd);
}

}  // namespace hvd
